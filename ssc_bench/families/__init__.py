"""Model families, each found by name from its configuration file's
``"family"`` key (``stereoscene`` where the file has none):
``ssc_bench/families/<family>.py``. A family module is all the harness
knows of a model; a new family is a new module here, its plain reference
under ``ssc_bench/reference/`` and its configuration, and no edit to the
harness. It gives:

- ``build_program(config, device)``: the program under test (float32),
  whose ``infer(batch)`` is the timed serving call and returns the
  served class map;
- ``build_reference(model_cfg, device, quantizer=None,
  checkpoint_blocks=False)``: the plain reference (plain torch, float32,
  nothing of the program), with every product through ``quantizer``
  where one is given and its memory-heavy blocks recomputed in the
  backward where ``checkpoint_blocks``; called as ``ref(batch,
  generator=None)`` on the generator's batches (``generate.py``) and
  returning a dict of tensors; one ``state_dict`` loads into both sides;
- ``DAMPED``: the weight names that ``weights.make`` scales down;
- ``SERVE_OUTPUTS``: name -> (module path, what its forward hook keeps
  of the module's output) on the timed path; ``STAGES``: (stage, module
  path) pairs whose forward pre-hooks bound the traced stage times
  (empty where the family has none);
- ``SERVE_NUMBERS`` and ``serve_frame(prog, ref, classes, label_shape)``:
  one frame's numbers from the kept outputs, the reference's outputs and
  the served class map; ``classes_of(outputs, label_shape)``: the class
  map a reference's outputs give (the control's answer);
  ``num_classes(config)``;
- ``train_program(model, config, device)``: (state, step), ``step(state,
  batch, generator) -> (state, logs)`` with ``logs["loss_total"]``;
  ``state.trainable`` the (name, parameter) pairs and
  ``state.optimizer`` a ``torch.optim.AdamW``;
- ``reference_losses(outputs, batch, config)``: the reference's loss
  terms by name; ``FIRST_OUTPUTS``: name -> module path whose first
  training output is compared (the number ``<name>_gap``);
- ``flop_inputs(net, model_cfg, batch)``: (args, kwargs) of the
  reference's forward that ``flops.py`` counts, shapes only;
- optionally, stages of the first training step judged alone:
  ``STAGE_NUMBERS``, ``FirstStage(model)`` (hooks that keep what a
  model's first training forward fed and made; ``.remove()`` returns it)
  and ``stage_gaps(ref, first, batch, config)``, the numbers from the
  reference at the step's weights run on ``first`` (the kept tensors,
  the ``FIRST_OUTPUTS`` and the first total loss ``loss1``).
"""

from __future__ import annotations

import importlib
from types import ModuleType
from typing import Dict

DEFAULT = "stereoscene"


def of(config: Dict) -> ModuleType:
    """The family module of a configuration file's contents."""
    name = config.get("family", DEFAULT)
    return importlib.import_module(f"{__name__}.{name}")
