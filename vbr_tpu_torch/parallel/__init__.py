"""The multi-device layer on ``torch.distributed``.

Counterpart of ``vbr_tpu/parallel/``.  JAX's ``shard_map`` is one
controller driving every device of a mesh; here each device is one
process (a rank), and each rank runs its shard's local program on its own
device (``cuda:{local rank}``, or the CPU when asked).  The mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with the JAX package's axis
names (``"data"``, ``"cam"``, ``"grid"``; ``carve_sharded.make_carve_mesh``),
and the JAX collectives become their ``torch.distributed`` forms on the
groups of those axes: ``all_gather`` → ``all_gather_into_tensor``,
``psum`` → ``all_reduce``, ``ppermute`` → a ring of ``batch_isend_irecv``.
Every runner gives every rank the whole result, equal to the host array
the JAX function returns.

  * ``carve_sharded`` — the process group, the mesh, the sharded gather
    carve;
  * ``pipeline_sharded`` — frozen MOG apply + morphology (+ cleanup) +
    gather carve, sharded;
  * ``pallas_sharded`` — the production step (kernels K2 and K1 on each
    rank) and the superblock placement;
  * ``mesh_sharded`` — marching cubes over x-slabs with a halo ring.
"""
