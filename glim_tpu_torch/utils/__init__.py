"""Host-side utilities: configuration, logging, callback slots, module registry,
time keeping and trajectory bookkeeping (numpy copies of glim_tpu.utils)."""
