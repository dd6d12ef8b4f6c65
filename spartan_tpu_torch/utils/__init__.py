"""Host utilities of the port: errors, canonical serialization and the
Fiat-Shamir transcript (copies of ``spartan_tpu/utils``' modules)."""
