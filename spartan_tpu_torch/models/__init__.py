"""R1CS model and the random test-circuit synthesizer (copies of
``spartan_tpu/models``' modules)."""
