"""Host-side scalar layer of the port: exact Python-int BLS12-381 field and
curve arithmetic, the native C++ runtime (transcript, matrix serialization,
pairing, G1 linear combinations, matrix evaluation) and its pairing entry
points. The port's own copy of the parts of ``spartan_tpu/host`` it uses.
"""
