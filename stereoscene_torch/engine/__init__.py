"""Training orchestration (port of ``stereoscene_tpu/engine/``)."""
