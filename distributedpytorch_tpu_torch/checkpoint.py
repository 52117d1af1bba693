"""Checkpoint resolution, reference-format ``.pth`` weights and the
trainer's native checkpoint.

Counterpart of ``distributedpytorch_tpu/checkpoint.py`` (the ``.pth``
interop and the single-device subset of native save/resume). The port's
``UNet.state_dict()`` keys are the reference's tensor names, so a
reference ``.pth`` loads with plain ``load_state_dict``.
``params_from_jax`` carries weights across from the JAX package as numpy
(tests and parity tools), the UNet's params or milesial's ``(params,
batch_stats)``; it keeps its own copy of the layout and name rules.

The port's native checkpoint, ``<dir>/<method>.pt``, is one ``torch.save``
file: the model's state dict under reference names, the optimizer, the
plateau scheduler, step, epoch, the loss records and a manifest. A JAX
``.ckpt`` is flax msgpack, which the port does not read yet: a resolved
``.ckpt`` raises and names the export that gives a ``.pth``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

# ConvBlock map: JAX path prefix → reference tensor stem; the two convs
# of a block sit at Sequential indices 0/2.
_BLOCK_MAPS: Tuple[Tuple[Tuple[str, ...], str], ...] = tuple(
    [(("encoder", f"block{i}"), f"encoder.conv{i}") for i in range(1, 5)]
    + [(("mid",), "mid")]
    + [(("decoder", f"block{i}"), f"decoder.conv{i}") for i in range(1, 5)]
)


#: The native checkpoint's extension (``torch.save``), and the formats the
#: trainer's ``-c`` resolves, in order.
NATIVE_EXT = ".pt"
TRAIN_EXTS = (NATIVE_EXT, ".pth")
#: The native checkpoint's layout version, in its manifest.
NATIVE_FORMAT = "distributedpytorch_tpu_torch/native/1"


def resolve_checkpoint(name: str, checkpoint_dir: str = "./checkpoints",
                       exts: Sequence[str] = (".ckpt", ".pth")) -> str:
    """A checkpoint reference → an existing file path.

    Accepts an explicit path, a bare method name (``DP`` →
    ``<dir>/DP<ext>`` for each of ``exts`` in turn: ``.ckpt`` then
    ``.pth`` for serving, ``.pt`` then ``.pth`` for the trainer), or a
    name with one of ``exts``, which tries only that format. Raises
    FileNotFoundError naming the primary candidate."""
    if os.path.isfile(name):  # a same-named DIRECTORY must not shadow
        return name
    base, explicit_ext = name, None
    for ext in exts:
        if base.endswith(ext):
            base, explicit_ext = base[: -len(ext)], ext
            break
    exts = (explicit_ext,) if explicit_ext else tuple(exts)
    for ext in exts:
        cand = os.path.join(checkpoint_dir, f"{base}{ext}")
        if os.path.isfile(cand):
            return cand
    raise FileNotFoundError(os.path.join(checkpoint_dir, f"{base}{exts[0]}"))


def strip_module_prefix(state_dict: Mapping[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    """DDP saves ``module.``-prefixed keys; drop the prefix."""
    return {
        (k[len("module."):] if k.startswith("module.") else k): v
        for k, v in state_dict.items()
    }


def load_pth(path: str) -> Dict[str, torch.Tensor]:
    """A reference-format ``.pth`` state dict on the CPU, prefix stripped.
    A ``.ckpt`` raises: the port cannot read flax msgpack yet."""
    if not path.endswith(".pth"):
        raise ValueError(
            f"{path} is not a .pth file — the port reads reference-format "
            f".pth weights only; export one from the JAX package with "
            f"distributedpytorch_tpu.checkpoint.export_reference_pth"
        )
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return strip_module_prefix(
        {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}
    )


def save_pth(state_dict: Mapping[str, torch.Tensor], path: str) -> None:
    """Write a reference-format ``.pth`` (CPU tensors, reference names)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, path)


# -- JAX params → state dict ---------------------------------------------------


def _name_map() -> Dict[Tuple[str, ...], str]:
    """JAX param path → reference tensor name."""
    m: Dict[Tuple[str, ...], str] = {}
    for jax_path, ref_stem in _BLOCK_MAPS:
        for conv, seq_idx in (("conv1", 0), ("conv2", 2)):
            m[jax_path + (conv, "kernel")] = f"{ref_stem}.conv_block.{seq_idx}.weight"
            m[jax_path + (conv, "bias")] = f"{ref_stem}.conv_block.{seq_idx}.bias"
    for i in range(1, 5):
        m[("decoder", f"upconv{i}", "kernel")] = f"decoder.deconv{i}.weight"
        m[("decoder", f"upconv{i}", "bias")] = f"decoder.deconv{i}.bias"
    m[("segmap", "kernel")] = "segmap.weight"
    m[("segmap", "bias")] = "segmap.bias"
    return m


def _kernel_to_torch(arr: np.ndarray, transposed: bool) -> np.ndarray:
    """JAX ``(kh, kw, I, O)`` → torch conv ``(O, I, kh, kw)``, or for a
    ConvTranspose ``(I, O, kh, kw)`` with a spatial flip: lax's transposed
    conv correlates with the mirrored kernel relative to torch's scatter
    form. Dropping the flip leaves every shape right and every output
    wrong."""
    if transposed:
        return arr[::-1, ::-1].transpose(2, 3, 0, 1)
    return arr.transpose(3, 2, 0, 1)


def _flatten(tree, prefix=()) -> Dict[Tuple[str, ...], np.ndarray]:
    """Path tuple → array; a key may itself be a path tuple."""
    if isinstance(tree, Mapping):
        flat = {}
        for k, v in tree.items():
            flat.update(_flatten(v, prefix + (k if isinstance(k, tuple)
                                              else (k,))))
        return flat
    return {prefix: np.asarray(tree)}


def _milesial_maps(n_levels: int):
    """(JAX params path → upstream milesial name, JAX batch_stats path →
    name) for a milesial model with ``n_levels`` widths. Upstream's
    DoubleConv is Sequential(Conv, BN, ReLU, Conv, BN, ReLU), hence the
    stems ``double_conv.{0,1,3,4}``; Down wraps it as ``maxpool_conv.1``,
    Up holds ``up`` and ``conv``, OutConv holds ``conv``."""
    pmap: Dict[Tuple[str, ...], str] = {}
    smap: Dict[Tuple[str, ...], str] = {}

    def double_conv(prefix: Tuple[str, ...], stem: str) -> None:
        for conv, bn, c_idx, b_idx in (("conv1", "bn1", 0, 1),
                                       ("conv2", "bn2", 3, 4)):
            pmap[prefix + (conv, "kernel")] = f"{stem}.{c_idx}.weight"
            pmap[prefix + (bn, "scale")] = f"{stem}.{b_idx}.weight"
            pmap[prefix + (bn, "bias")] = f"{stem}.{b_idx}.bias"
            smap[prefix + (bn, "mean")] = f"{stem}.{b_idx}.running_mean"
            smap[prefix + (bn, "var")] = f"{stem}.{b_idx}.running_var"

    double_conv(("inc",), "inc.double_conv")
    for i in range(1, n_levels):
        double_conv((f"down{i}", "conv"),
                    f"down{i}.maxpool_conv.1.double_conv")
    for i in range(1, n_levels):
        pmap[(f"up{i}", "up", "kernel")] = f"up{i}.up.weight"
        pmap[(f"up{i}", "up", "bias")] = f"up{i}.up.bias"
        double_conv((f"up{i}", "conv"), f"up{i}.conv.double_conv")
    pmap[("outc", "kernel")] = "outc.conv.weight"
    pmap[("outc", "bias")] = "outc.conv.bias"
    return pmap, smap


def _tensor(arr) -> torch.Tensor:
    # np.array copies: a device_get result may be read-only
    return torch.from_numpy(np.array(arr, dtype=np.float32, order="C"))


def params_from_jax(params, batch_stats=None) -> Dict[str, torch.Tensor]:
    """JAX weights as numpy — the nested mapping ``jax.device_get`` gives,
    or a flat one keyed by path tuples — → the port's state dict: UNet
    params → ``UNet`` names; milesial params and ``batch_stats`` →
    upstream milesial names, the running statistics included and
    ``num_batches_tracked`` 0, as the JAX package's
    ``export_milesial_state_dict`` writes them."""
    flat = _flatten(params)
    out: Dict[str, torch.Tensor] = {}
    if not any(path[0] == "inc" for path in flat):
        names = _name_map()
        for path, arr in flat.items():
            if path[-1] == "kernel":
                arr = _kernel_to_torch(arr, "upconv" in path[-2])
            out[names[path]] = _tensor(arr)
        return out
    if batch_stats is None:
        raise ValueError("milesial params need their batch_stats")
    levels = 1 + len({path[0] for path in flat if path[0].startswith("down")})
    pmap, smap = _milesial_maps(levels)
    for path, arr in flat.items():
        if path[-1] == "kernel":
            arr = _kernel_to_torch(arr, path[-2] == "up")
        out[pmap[path]] = _tensor(arr)
    for path, arr in _flatten(batch_stats).items():
        name = smap[path]
        out[name] = _tensor(arr)
        out[name.rsplit(".", 1)[0] + ".num_batches_tracked"] = torch.tensor(
            0, dtype=torch.long)
    return out


# -- native save/resume --------------------------------------------------------


def save_native(path: str, model: torch.nn.Module,
                optimizer: torch.optim.Optimizer, scheduler_state: dict,
                step: int, epoch: int, records_state: Optional[dict],
                manifest: Mapping[str, Any]) -> None:
    """Write the trainer's full state to ``path`` atomically (a temporary
    file renamed into place): a crash mid-write leaves the previous file
    whole."""
    payload = {
        "model": {k: v.detach().cpu() for k, v in model.state_dict().items()},
        "optimizer": optimizer.state_dict(),
        "scheduler": dict(scheduler_state),
        "step": int(step),
        "epoch": int(epoch),
        "records": records_state,
        "manifest": {"format": NATIVE_FORMAT, **manifest},
    }
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_native(path: str) -> Dict[str, Any]:
    """A native checkpoint's payload, tensors on the CPU. Raises
    ValueError for a file that is not one."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    fmt = (payload.get("manifest") or {}).get("format") \
        if isinstance(payload, dict) else None
    if fmt != NATIVE_FORMAT:
        raise ValueError(
            f"{path} is not a native checkpoint of the port (format "
            f"{fmt!r}, expected {NATIVE_FORMAT!r})"
        )
    return payload
