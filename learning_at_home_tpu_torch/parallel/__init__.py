"""parallel of the PyTorch port: the pod tier's MoE layer
(``sharded_moe.py``) and, on meshes of ``torch.distributed`` ranks, the
mesh (``mesh.py``), the bring-up (``multihost.py``), the differentiable
collectives (``comm.py``), ring attention (``ring_attention.py``) and a
group of rank processes (``launch.py``); see the package docstring."""
