"""The train CLI with ``--spatial-shards 2`` on two gloo CPU ranks at TINY
(one sample a step, its voxel grid's X split in two slabs) against the
same CLI in one process: the JAX CLI's ``--spatial-shards``
(tools/train.py:44-45, 98-113, 147-151).

- Every step's loss terms within 1e-5 relative at step 1 and 1e-3 at
  step 2 (step 1 moves the parameters by Adam's lr * sign(g), which
  rounding can flip where g is about 0), the same on both ranks, and the
  two ranks' parameters and buffers bitwise equal at the end;
- the loop's eval after the epoch, in the same layout: each val frame
  scored once (``eval_frames``), and the 25 ``semkitti_*`` metrics those
  of one process;
- the refusal of a shard count that does not divide the ranks.
"""

import json
import math
import os

import numpy as np
import pytest
import torch

from tests import torch_ranks
from tests.test_torch_data import write_semkitti_tree
from tests.test_torch_lidar import write_lidar
from tests.test_torch_train_cli import TINY_CFG

TRAIN_FRAMES = ("000000", "000001")
VAL_FRAMES = ("000000", "000005")
TERMS = ("loss_voxel_ce_0", "loss_voxel_sem_scal_0", "loss_voxel_geo_scal_0",
         "loss_depth", "loss_total")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def argv(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sp_tree"))
    _, ann = write_semkitti_tree(root, frame_ids=TRAIN_FRAMES, seq="00",
                                 seed=1)
    write_semkitti_tree(root, frame_ids=VAL_FRAMES, seq="08", seed=2)
    lidar = write_lidar(root, "00", TRAIN_FRAMES, n_points=6000)
    return [TINY_CFG, "--device", "cpu", "--max-epochs", "1",
            "--deterministic-data", "--seed", "0", "--cfg-options",
            f"data.val.data_root={root}", f"data.val.ann_file={ann}",
            f"data.train.data_root={root}", f"data.train.ann_file={ann}",
            f"lidar_root={lidar}", f"lidarseg_root={lidar}",
            "evaluation.interval=1"]


def _evals(work_dir):
    with open(os.path.join(work_dir, "train_log.jsonl")) as f:
        records = [json.loads(line) for line in f]
    return [r["eval"] for r in records if "eval" in r]


@pytest.fixture(scope="module")
def runs(argv, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sp_runs")
    sharded_dir = str(tmp / "sharded")
    sharded = [r[0] for r in torch_ranks.run_ranks(
        torch_ranks.train_cli_rank, 2, tmp,
        [(argv + ["--spatial-shards", "2", "--work-dir", sharded_dir],
          None)], join=False, timeout=4 * torch_ranks.TIMEOUT_S)]
    one_dir = str(tmp / "one")
    one, = torch_ranks.train_cli_rank(
        0, 1, None, [(argv + ["--work-dir", one_dir], None)])
    return dict(sharded=sharded, one=one, evals=_evals(sharded_dir),
                one_evals=_evals(one_dir))


def test_sharded_cli_steps_match_one_process(runs):
    sharded, one = runs["sharded"], runs["one"]
    assert [r["step"] for r in sharded] == [2, 2] and one["step"] == 2
    for i, rtol in enumerate((1e-5, 1e-3)):
        assert sharded[0]["steps"][i] == sharded[1]["steps"][i]
        for key in TERMS:
            np.testing.assert_allclose(sharded[0]["steps"][i][key],
                                       one["steps"][i][key], rtol=rtol,
                                       err_msg=f"step {i + 1} {key}")
    assert sharded[0]["steps"][0]["loss_depth"] > 0
    for k, v in sharded[0]["state"].items():
        assert torch.equal(v, sharded[1]["state"][k]), k


def test_sharded_cli_eval_scores_each_frame_once(runs):
    (got,), (want,) = runs["evals"], runs["one_evals"]
    assert got["eval_frames"] == want["eval_frames"] == len(VAL_FRAMES)
    keys = [k for k in want if k.startswith("semkitti_")]
    assert len(keys) == 25
    for k in keys:
        assert got[k] == want[k] or (math.isnan(got[k])
                                     and math.isnan(want[k])), k


def test_shards_that_do_not_divide_the_ranks_are_refused(argv, tmp_path):
    from stereoscene_torch.tools import train as train_cli

    with pytest.raises(ValueError, match="spatial shards 2 do not divide "
                                         "the 1 ranks"):
        train_cli.main(argv + ["--spatial-shards", "2", "--work-dir",
                               str(tmp_path)])
