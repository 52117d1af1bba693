"""Checkpoint resolution and reference-format ``.pth`` weights.

Counterpart of the ``.pth`` half of ``distributedpytorch_tpu/checkpoint.py``.
The port's ``UNet.state_dict()`` keys are the reference's tensor names, so
a reference ``.pth`` loads with plain ``load_state_dict``.
``params_from_jax`` carries weights across from the JAX package as numpy
(tests and parity tools); it keeps its own copy of the layout rules.

A native ``.ckpt`` is flax msgpack, which the port does not read yet: a
resolved ``.ckpt`` raises and names the export that gives a ``.pth``.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

# ConvBlock map: JAX path prefix → reference tensor stem; the two convs
# of a block sit at Sequential indices 0/2.
_BLOCK_MAPS: Tuple[Tuple[Tuple[str, ...], str], ...] = tuple(
    [(("encoder", f"block{i}"), f"encoder.conv{i}") for i in range(1, 5)]
    + [(("mid",), "mid")]
    + [(("decoder", f"block{i}"), f"decoder.conv{i}") for i in range(1, 5)]
)


def resolve_checkpoint(name: str, checkpoint_dir: str = "./checkpoints") -> str:
    """A checkpoint reference → an existing file path.

    Accepts an explicit path, a bare method name (``DP`` →
    ``<dir>/DP.ckpt``, falling back to ``<dir>/DP.pth``), or an
    extension-suffixed name, which tries only that format. Raises
    FileNotFoundError naming the primary candidate."""
    if os.path.isfile(name):  # a same-named DIRECTORY must not shadow
        return name
    base, explicit_ext = name, None
    for ext in (".ckpt", ".pth"):
        if base.endswith(ext):
            base, explicit_ext = base[: -len(ext)], ext
            break
    exts = (explicit_ext,) if explicit_ext else (".ckpt", ".pth")
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


def params_from_jax(params) -> Dict[str, torch.Tensor]:
    """JAX UNet params as numpy — the nested mapping ``jax.device_get``
    gives, or a flat one keyed by path tuples — → the port's ``UNet``
    state dict."""
    flat = _flatten(params)
    names = _name_map()
    out: Dict[str, torch.Tensor] = {}
    for path, arr in flat.items():
        if path[-1] == "kernel":
            arr = _kernel_to_torch(arr, "upconv" in path[-2])
        # np.array copies: a device_get result may be read-only
        out[names[path]] = torch.from_numpy(
            np.array(arr, dtype=np.float32, order="C")
        )
    return out
