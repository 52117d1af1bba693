"""The mesh-spec grammar: ``-t DxMxS[@opt[+opt]]``.

The port's own copy of the grammar of the JAX package's
``parallel/mesh.py`` (``AXES``, ``PARAMS_RULES``, ``MODEL_ROLES``,
``MeshConfig``, ``axis_layout``, ``is_mesh_spec``, ``parse_mesh_spec``,
``canonical_spec``, ``spec_is_pipeline``, ``spec_is_hybrid`` and
``LEGACY_PATTERNS``), with its error messages word for word. It imports
neither torch nor jax: the CLI parses a spec with it before any backend
is loaded.

A point of the mesh is three axis sizes over ``('data', 'model',
'stage')``, what the model axis parallelizes (``channel``: conv
out-channels; ``spatial``: image rows) and how the parameters and Adam's
state are cut (``PARAMS_RULES``). ``parallel/strategy.GenericMesh`` runs
the points the port trains.

``state_leaf_spec`` is the port's form of the JAX rule of the same name.
The port's tensors are not flax's: a conv weight is OIHW, so its
out-channels are dim 0, and ``torch.nn.ConvTranspose2d`` keeps them on
dim 1 (``parallel/channels.py``). Where the JAX ``fsdp`` rule cuts a
leaf's largest axis that divides the data axis, the port always cuts
dim 0: ``fully_shard``'s ``Shard(0)`` in torch.chunk's pieces under
``fsdp``, and under ``fsdp+channel`` dim 0 of each channel slice where
its rows divide the data axis (``parallel/zero.py``), the slice whole on
every rank otherwise. So a 3×3 conv's slice is cut on its out-channels
where JAX cuts its in-channels, and its biases and BatchNorm vectors are
cut where JAX keeps them whole; what stays whole on every rank is the
1-channel head, as in JAX.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Sequence, Tuple

#: Canonical axis order. Axes of size 1 are left out of a mesh's layout,
#: and the model axis is named by its role.
AXES = ("data", "model", "stage")

#: params-rule vocabulary (how parameters AND Adam state shard):
#:   replicate    — full copy per device (DP/DDP/SP/MP and hybrids);
#:   channel      — out-channel axis over 'model' (TP);
#:   fsdp         — each leaf cut over 'data' (ZeRO-3);
#:   fsdp+channel — both at once (out-channel over 'model', the slice
#:                  again over 'data').
PARAMS_RULES = ("replicate", "channel", "fsdp", "fsdp+channel")

MODEL_ROLES = ("channel", "spatial")

_SPEC_RE = re.compile(r"^(\d+)x(\d+)x(\d+)(?:@([a-z0-9+]+))?$")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """One point in mesh-shape space: axis sizes, sharding rules, and
    the batch/LR semantics the strategy layer reads."""

    data: int = 1
    model: int = 1
    stage: int = 1
    #: what the 'model' axis parallelizes — "channel" (TP) | "spatial" (SP)
    model_role: str = "channel"
    #: how params/opt-state shard — one of PARAMS_RULES
    params: str = "replicate"
    #: torchrun convention (batch_size is PER-PROCESS, global = b x data
    #: rows) vs torch-DP convention (batch_size is the global batch)
    per_process_batch: bool = False
    #: eligible for the reference's lr x world quirk (DDP family only)
    lr_scaling: bool = False
    #: sharded-batch strategies need the batch divisible by 'data'
    drop_last: bool = False

    def __post_init__(self):
        for axis in AXES:
            if int(getattr(self, axis)) < 1:
                raise ValueError(f"mesh axis {axis!r} must be >= 1")
        if self.params not in PARAMS_RULES:
            raise ValueError(
                f"params rule must be one of {PARAMS_RULES}, "
                f"got {self.params!r}"
            )
        if self.model_role not in MODEL_ROLES:
            raise ValueError(
                f"model_role must be one of {MODEL_ROLES}, "
                f"got {self.model_role!r}"
            )

    @property
    def size(self) -> int:
        return int(self.data) * int(self.model) * int(self.stage)

    @property
    def model_axis_name(self) -> str:
        """The model axis carries its role as its mesh name: 'spatial'
        or 'model'."""
        return "spatial" if self.model_role == "spatial" else "model"

    @property
    def is_pipeline(self) -> bool:
        return self.stage > 1


def axis_layout(cfg: MeshConfig) -> Tuple[Tuple[str, int], ...]:
    """((axis name, size), ...) for the axes with size > 1, in canonical
    (data, model, stage) order. Empty for the 1x1x1 point (single
    device)."""
    layout: List[Tuple[str, int]] = []
    if cfg.data > 1:
        layout.append(("data", int(cfg.data)))
    if cfg.model > 1:
        layout.append((cfg.model_axis_name, int(cfg.model)))
    if cfg.stage > 1:
        layout.append(("stage", int(cfg.stage)))
    return tuple(layout)


def state_leaf_spec(cfg: MeshConfig, shape: Sequence[int], out_dim: int = 0
                    ) -> Tuple[Tuple[str, ...], ...]:
    """The axes that cut each dim of a port tensor of ``shape`` whose
    out-channels lie on ``out_dim`` (0 for a conv's OIHW weight, a bias
    and a BatchNorm vector; 1 for a transposed conv's weight), outer axis
    first; ``()`` for a dim that is whole.

    ``channel`` and ``fsdp+channel``: ``out_dim`` over 'model' when it
    divides. ``fsdp``: dim 0 over 'data', in torch.chunk's pieces
    (``fully_shard``). ``fsdp+channel``: then dim 0 of the channel slice
    over 'data' where its rows divide; a slice whose rows do not divide
    stays whole on every rank."""
    ndim = len(shape)
    spec: List[Tuple[str, ...]] = [()] * ndim
    if ndim == 0:
        return ()
    rows = int(shape[0])
    rule = cfg.params
    if rule in ("channel", "fsdp+channel") and cfg.model > 1:
        size = int(cfg.model)
        if shape[out_dim] % size == 0 and shape[out_dim] >= size:
            spec[out_dim] = (cfg.model_axis_name,)
            if out_dim == 0:
                rows //= size
    if rule == "fsdp" and cfg.data > 1:
        spec[0] = ("data",)
    elif rule == "fsdp+channel" and cfg.data > 1:
        size = int(cfg.data)
        if rows % size == 0 and rows >= size:
            spec[0] = spec[0] + ("data",)
    return tuple(spec)


# -- mesh-spec grammar -------------------------------------------------------
def is_mesh_spec(name) -> bool:
    """Does this ``-t`` value look like a mesh spec (``DxMxS[@opts]``)?
    Syntactic only — ``parse_mesh_spec`` validates semantics."""
    return isinstance(name, str) and _SPEC_RE.match(name) is not None


def parse_mesh_spec(spec: str) -> MeshConfig:
    """``DxMxS[@opt[+opt]]`` -> MeshConfig. Options: ``tp`` (channel
    model axis, the default), ``sp`` (spatial model axis), ``fsdp``
    (params/opt-state sharded over 'data'). Mesh-spec strategies use the
    multi-process (torchrun/FSDP) batch convention: ``batch_size`` is
    per-process, no DDP lr scaling."""
    m = _SPEC_RE.match(str(spec))
    if m is None:
        raise ValueError(
            f"not a mesh spec: {spec!r} (expected DxMxS[@opt[+opt]], "
            f"e.g. 4x1x2, 2x2x1@fsdp, 1x4x1@sp)"
        )
    data, model, stage = (int(m.group(i)) for i in (1, 2, 3))
    opts = set((m.group(4) or "").split("+")) - {""}
    unknown = opts - {"tp", "sp", "fsdp"}
    if unknown:
        raise ValueError(
            f"mesh spec {spec!r}: unknown option(s) {sorted(unknown)} "
            f"(known: tp, sp, fsdp)"
        )
    if "sp" in opts and "tp" in opts:
        raise ValueError(
            f"mesh spec {spec!r}: the model axis is either spatial (sp) "
            f"or channel (tp), not both"
        )
    if "sp" in opts and model <= 1:
        raise ValueError(
            f"mesh spec {spec!r}: @sp needs a model axis > 1 to shard "
            f"image rows over"
        )
    role = "spatial" if "sp" in opts else "channel"
    if "fsdp" in opts:
        params = "fsdp+channel" if (model > 1 and role == "channel") else "fsdp"
    elif model > 1 and role == "channel":
        params = "channel"
    else:
        params = "replicate"
    return MeshConfig(
        data=data, model=model, stage=stage, model_role=role, params=params,
        per_process_batch=True, lr_scaling=False, drop_last=data > 1,
    )


def canonical_spec(cfg: MeshConfig) -> str:
    """The round-trippable spec string for a config — what checkpoint
    manifests record as ``mesh_spec``."""
    opts = []
    if cfg.model > 1 and cfg.model_role == "spatial":
        opts.append("sp")
    if "fsdp" in cfg.params:
        opts.append("fsdp")
    suffix = ("@" + "+".join(opts)) if opts else ""
    return f"{cfg.data}x{cfg.model}x{cfg.stage}{suffix}"


def spec_is_pipeline(name) -> bool:
    """Does this ``-t`` value name a mesh spec with a stage axis? Cheap
    and non-raising."""
    m = _SPEC_RE.match(str(name)) if isinstance(name, str) else None
    return m is not None and int(m.group(3)) > 1


def spec_is_hybrid(name) -> bool:
    """>= 2 non-trivial axes: a 'hybrid' geometry."""
    m = _SPEC_RE.match(str(name)) if isinstance(name, str) else None
    if m is None:
        return False
    return sum(int(m.group(i)) > 1 for i in (1, 2, 3)) >= 2


# -- legacy strategies as named points ---------------------------------------
#: Structural pattern of each legacy ``-t`` strategy (axis sizes are
#: placeholders — 2 means "spans devices"; what matters is WHICH axes
#: exist and which rules apply).
LEGACY_PATTERNS: Dict[str, MeshConfig] = {
    "singleGPU": MeshConfig(),
    "DP": MeshConfig(data=2, drop_last=True),
    "DDP": MeshConfig(data=2, per_process_batch=True, lr_scaling=True,
                      drop_last=True),
    "SP": MeshConfig(model=2, model_role="spatial"),
    "DDP_SP": MeshConfig(data=2, model=2, model_role="spatial",
                         per_process_batch=True, lr_scaling=True,
                         drop_last=True),
    "TP": MeshConfig(model=2, params="channel"),
    "FSDP": MeshConfig(data=2, params="fsdp", per_process_batch=True,
                       drop_last=True),
    "MP": MeshConfig(stage=2),
    "DDP_MP": MeshConfig(data=2, stage=2, per_process_batch=True,
                         lr_scaling=True, drop_last=True),
}

