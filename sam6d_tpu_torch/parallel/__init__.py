"""Multi-rank scaling on `torch.distributed`: data- and tensor-parallel
training, data- and hypothesis-parallel serving, the BOP sweeps' merge.

Counterpart of `sam6d_tpu/parallel/`, where everything is one
`jax.sharding.Mesh`.  Here a mesh is a `DeviceMesh` over the ranks of
the process group (`mesh.py`), one rank a card (NCCL) or a CPU process
(gloo), and what pjit and shard_map insert is written out:

  * `dp` axis: frames, instance batches, the training batch; gradients
    averaged over it, BatchNorm moments summed over it (`sharding.py`);
  * `tp` axis: Megatron pairs over the ViT and transformer Dense layers
    (`sharding.py`, `collectives.py`);
  * `hyp` axis: the coarse solve's hypothesis budget (`hyp_parallel.py`);
    PEM serving over `dp` and `hyp` is `pem_serving.MeshPEMRunner`.
"""

from sam6d_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
