"""The benchmark of stereoscene_torch: one cell a run, driven by the
names in BENCHMARK.json (see run.py)."""
