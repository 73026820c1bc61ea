"""Training of the epi modules (port of ``cvd_tpu/train``)."""
