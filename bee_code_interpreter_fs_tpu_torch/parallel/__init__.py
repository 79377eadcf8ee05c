"""Sequence parallelism on one card: meshes, the ring permute, ring
attention (with the ring-step flash kernel) and Ulysses attention. The
dp/tp/ep sharding of parallel/sharding.py and the collectives that cross
cards come with the distributed slice of the port."""

from bee_code_interpreter_fs_tpu_torch.parallel.collectives import ring_permute
from bee_code_interpreter_fs_tpu_torch.parallel.mesh import (
    AXES,
    Mesh,
    MeshSpec,
    best_mesh_shape,
    make_mesh,
)
from bee_code_interpreter_fs_tpu_torch.parallel.ring_attention import ring_attention
from bee_code_interpreter_fs_tpu_torch.parallel.ulysses import ulysses_attention

__all__ = [
    "AXES",
    "Mesh",
    "MeshSpec",
    "best_mesh_shape",
    "make_mesh",
    "ring_attention",
    "ring_permute",
    "ulysses_attention",
]
