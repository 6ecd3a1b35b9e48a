"""Production meshes (DESIGN.md §7), the host mesh, sharding-rule overlays
and the card's constants (port of ``repro/launch/mesh.py``).

``make_production_mesh`` returns an abstract :class:`MeshSpec` (names and
sizes, no devices), so importing this module or building a production mesh
touches no device state, as the dry-run contract requires.
``make_host_mesh`` is the executing mesh: the ranks of an initialised
process group as a 1-D ``"data"`` mesh, or as ``("data", "model")`` with a
``model`` axis for the tensor-parallel cells.

The reference's v5e roofline constants are not carried over.  In their
place stand the H100's, from NVIDIA's data sheet for the SXM part at its
full power limit.
"""

from __future__ import annotations

from typing import Optional

from ..distributed.sharding import DEFAULT_RULES, MeshSpec

CARD = "NVIDIA H100 80GB HBM3, 700 W (SXM datasheet)"
PEAK_FLOPS_BF16 = 989e12      # FLOP/s, dense
HBM_BW = 3.35e12              # B/s, HBM3
HBM_BYTES = 80e9              # B


def hbm_bytes() -> float:
    """The card's own memory where a card is present, else the data sheet's."""
    import torch

    if torch.cuda.is_available():
        return float(torch.cuda.get_device_properties(0).total_memory)
    return HBM_BYTES


def make_production_mesh(*, multi_pod: bool = False) -> MeshSpec:
    """16x16 = (data, model) single pod; 2x16x16 = (pod, data, model) for two."""
    if multi_pod:
        return MeshSpec(("pod", "data", "model"), (2, 16, 16))
    return MeshSpec(("data", "model"), (16, 16))


def backend_for(device: str) -> str:
    """The process-group backend for ``device``: NCCL on ``cuda``, gloo on
    ``cpu``.  There is no fallback from one to the other."""
    kind = str(device).split(":")[0]
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"no process-group backend for device {device!r}")
    return "nccl" if kind == "cuda" else "gloo"


def init_process_group(device: str, init_method: str, world_size: int = 1,
                       rank: int = 0) -> None:
    """``torch.distributed.init_process_group`` with :func:`backend_for`'s
    backend; ``init_method`` is ``file://...`` or ``tcp://host:port``."""
    import torch.distributed as dist

    dist.init_process_group(backend_for(device), init_method=init_method,
                            world_size=world_size, rank=rank)


def make_host_mesh(device: str = "cuda", model: Optional[int] = None):
    """The initialised process group's ranks as a DeviceMesh on ``device``
    (whose backend the group must have): 1-D ``"data"``, or with ``model``
    a ``("data", "model")`` mesh of world / model x model ranks, each run
    of ``model`` consecutive ranks one data row."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh: no process group; call init_process_group first")
    kind = str(device).split(":")[0]
    if dist.get_backend() != backend_for(kind):
        raise RuntimeError(f"make_host_mesh: the process group runs {dist.get_backend()}, "
                           f"device {device!r} needs {backend_for(kind)}")
    world = dist.get_world_size()
    if model is None:
        return init_device_mesh(kind, (world,), mesh_dim_names=("data",))
    if model < 1 or world % model:
        raise ValueError(f"make_host_mesh: model {model} does not divide the world of {world}")
    return init_device_mesh(kind, (world // model, model), mesh_dim_names=("data", "model"))


def rules_for(kind: str, cfg=None) -> dict:
    """Sharding-rule overlay per entry-point kind (and parallelism policy).

    decode: the KV cache shards its *sequence* dim over the model axis
    (flash-decoding style); train/prefill keep sequence unsharded and put the
    model axis on heads/ffn/vocab.

    cfg.parallelism == "dp" (§Perf H3): batch shards over BOTH axes and all
    tensor-parallel mappings drop — pure data parallel + ZeRO, for models too
    small to amortize TP collectives (smollm-135m on 256 chips).
    """
    rules = dict(DEFAULT_RULES)
    if kind == "decode":
        rules["kv_seq"] = "model"
    if cfg is not None and getattr(cfg, "parallelism", "tp") == "dp":
        rules["batch"] = ("data", "model")
        for ax in ("heads", "kv_heads", "ffn", "vocab", "expert",
                   "expert_ffn", "ssm_inner", "kv_seq"):
            rules[ax] = None
        rules["moe_cap"] = ("data", "model")
    return rules
