"""Scale-out on one controller: a mesh is an ordered tuple of devices, a
sharded table a list of tensors, one on each (``parallel/sharded.py``), and
the sharded prover drives them from one process (``parallel/sharded_prove.py``).

Counterpart of ``spartan_tpu/parallel``, whose ``shard_map`` over a JAX
``Mesh`` is also one controller: the transcript runs on the host and every
cross-shard sum is exact mod r, so the proof is byte-identical at every
device count.
"""
