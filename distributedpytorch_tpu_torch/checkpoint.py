"""Checkpoint resolution, reference-format ``.pth`` weights and the
trainer's native checkpoint.

Counterpart of ``distributedpytorch_tpu/checkpoint.py`` (the ``.pth``
interop and the replicated-state subset of native save/resume). The port's
``UNet.state_dict()`` keys are the reference's tensor names, so a
reference ``.pth`` loads with plain ``load_state_dict``.
``params_from_jax`` carries weights across from the JAX package as numpy
(tests and parity tools), the UNet's params or milesial's ``(params,
batch_stats)``; it keeps its own copy of the layout and name rules.

The port's native checkpoint, ``<dir>/<method>.pt``, is one ``torch.save``
file: the model's state dict under reference names, the optimizer (under
``bf16_params`` with the f32 master weights), the plateau scheduler,
step, epoch, the loss records, the trainer's small state (best val Dice,
best val loss, stale epochs) and a manifest, which records the saving
run's strategy, world size and precision policy, as the JAX package's
does (checkpoint.py:122, :147-150). As in the JAX package
(checkpoint.py:184-400):

* each file ends in a footer with the SHA-256 of what precedes it
  (``torch.load`` reads the file as it is: the footer follows the zip
  archive); a restore verifies it and falls back to the newest intact
  file of the chain, with a warning;
* a save keeps the newest ``keep`` files of the path, ``<tag>.pt``,
  ``<tag>.pt.1``, …, rotated under one lock;
* ``host_snapshot`` copies the state to the host in the calling thread;
  ``write_payload`` writes it there, ``save_native_async`` on one
  background writer thread in submission order, its future raising the
  write's error.
The state is replicated over DDP's ranks, so the main process writes it
and a run at any world size restores it. Under ``-t MP`` each stage's
layers live on its own device and ``state_dict()`` gathers them under
the singleGPU keys (``.cpu()`` per tensor here; under ``-t DDP_MP`` on
rank 0, whose stages hold the same weights as every rank's; the manifest
records the world, stages, microbatches and schedule), and under ``-t DP`` the
model itself sits on the first device: a checkpoint of any method loads
under any other, at any stage count, with nothing to reshard
(``load_state_dict`` copies each tensor to its parameter's device, and
the optimizer's state follows its parameter's). A JAX
``.ckpt`` is flax msgpack, which the port does not read yet: a resolved
``.ckpt`` raises and names the export that gives a ``.pth``.
"""

from __future__ import annotations

import hashlib
import io
import itertools
import logging
import os
import queue as queue_mod
import threading
from concurrent.futures import Future
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)

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
        if ext == NATIVE_EXT and retained_checkpoints(cand):
            # the live slot is empty but the chain survives: the restore
            # walks it from the primary path
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
    """Write a reference-format ``.pth`` (CPU tensors, reference names,
    floating tensors in float32 as the reference's are)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({k: (v.detach().cpu().float() if v.is_floating_point()
                    else v.detach().cpu())
                for k, v in state_dict.items()}, path)


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

_HASH_MAGIC = b"DPTSHA256"
_FOOTER_LEN = len(_HASH_MAGIC) + 32
_TMP_COUNTER = itertools.count()
# one lock around every rotate, rename and prune of a retention chain: the
# writer thread and a synchronous save may share a chain
_RETENTION_LOCK = threading.Lock()


class CheckpointCorruptError(ValueError):
    """A checkpoint file whose content hash does not verify, or that does
    not parse."""


def retained_checkpoints(path: str) -> List[str]:
    """The retention chain on disk, newest first: ``path``, ``path.1``, …
    (the restore's fallback order)."""
    out = [path] if os.path.exists(path) else []
    for i in range(1, 64):
        cand = f"{path}.{i}"
        if os.path.exists(cand):
            out.append(cand)
    return out


def _rotate_retained(path: str, keep: int) -> None:
    """``path`` → ``path.1`` → … → ``path.(keep-1)``; ``keep <= 1`` keeps
    the live file only."""
    if keep <= 1 or not os.path.exists(path):
        return
    for i in range(keep - 1, 0, -1):
        src = path if i == 1 else f"{path}.{i - 1}"
        if os.path.exists(src):
            os.replace(src, f"{path}.{i}")


def _prune_retained(path: str, keep: int) -> None:
    for i in range(max(1, keep), 64):
        stale = f"{path}.{i}"
        if os.path.exists(stale):
            os.remove(stale)


def _detached_copy(obj):
    """``obj`` with every tensor copied to the host, so later steps cannot
    change what is written (a CPU tensor is cloned, not shared)."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach()
        return t.clone() if t.device.type == "cpu" else t.cpu()
    if isinstance(obj, dict):
        return {k: _detached_copy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_detached_copy(v) for v in obj)
    return obj


def host_snapshot(model: torch.nn.Module, optimizer, scheduler_state: dict,
                  step: int, epoch: int, records_state: Optional[dict],
                  manifest: Mapping[str, Any],
                  train_meta: Optional[dict] = None) -> Dict[str, Any]:
    """The trainer's full state as a payload of host tensors, taken now:
    the part of a save that must happen in the step loop's thread."""
    return {
        "model": _detached_copy(model.state_dict()),
        "optimizer": _detached_copy(optimizer.state_dict()),
        "scheduler": dict(scheduler_state),
        "step": int(step),
        "epoch": int(epoch),
        "records": records_state,
        "train_meta": dict(train_meta or {}),
        "manifest": {"format": NATIVE_FORMAT, **manifest},
    }


def write_payload(path: str, payload: Mapping[str, Any], keep: int = 1
                  ) -> str:
    """Serialize ``payload``, append the hash footer and write ``path``
    atomically (a uniquely named temporary file renamed into place),
    rotating the chain first so the previous file survives as
    ``path.1`` and pruning it to ``keep`` files."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    buf = io.BytesIO()
    torch.save(dict(payload), buf)
    blob = buf.getvalue()
    tmp = f"{path}.tmp.{os.getpid()}.{next(_TMP_COUNTER)}"
    with open(tmp, "wb") as f:
        f.write(blob)
        f.write(_HASH_MAGIC)
        f.write(hashlib.sha256(blob).digest())
    with _RETENTION_LOCK:
        _rotate_retained(path, keep)
        os.replace(tmp, path)
        _prune_retained(path, keep)
    return path


_writer_lock = threading.Lock()
_writer_queue: Optional[queue_mod.Queue] = None


def _writer_loop(q: queue_mod.Queue) -> None:
    while True:
        fut, path, payload, keep = q.get()
        if not fut.set_running_or_notify_cancel():
            continue
        try:
            fut.set_result(write_payload(path, payload, keep=keep))
        except BaseException as exc:  # raised by fut.result()
            fut.set_exception(exc)


def save_native_async(path: str, payload: Mapping[str, Any],
                      keep: int = 1) -> Future:
    """``write_payload`` on the background writer thread, saves written in
    the order they are submitted; the future resolves to ``path`` when the
    file is in place, or raises the write's error. ``payload`` is a
    ``host_snapshot``, taken by the caller."""
    global _writer_queue
    with _writer_lock:
        if _writer_queue is None:
            _writer_queue = queue_mod.Queue()
            threading.Thread(target=_writer_loop, args=(_writer_queue,),
                             daemon=True, name="dpt-ckpt-writer").start()
    fut: Future = Future()
    _writer_queue.put((fut, path, payload, keep))
    return fut


def _read_verified(path: str) -> Dict[str, Any]:
    """One file's payload, its hash verified when it has a footer (a file
    without one loads unverified); a mismatch or an unreadable payload
    raises ``CheckpointCorruptError``."""
    with open(path, "rb") as f:
        blob = f.read()
    if (len(blob) > _FOOTER_LEN
            and blob[-_FOOTER_LEN:-32] == _HASH_MAGIC):
        body, digest = blob[:-_FOOTER_LEN], blob[-32:]
        if hashlib.sha256(body).digest() != digest:
            raise CheckpointCorruptError(
                f"{path}: content hash mismatch (torn write or bit rot)")
        blob = body
    try:
        return torch.load(io.BytesIO(blob), map_location="cpu",
                          weights_only=True)
    except Exception as exc:
        raise CheckpointCorruptError(
            f"{path}: unreadable payload: {exc}") from exc


def read_payload(path: str) -> Dict[str, Any]:
    """The payload of the newest intact file of ``path``'s chain, with a
    warning when that is not ``path`` itself; raises
    ``CheckpointCorruptError`` when none is intact."""
    candidates = retained_checkpoints(path) or [path]
    for cand in candidates:
        try:
            payload = _read_verified(cand)
        except CheckpointCorruptError as exc:
            logger.warning("checkpoint integrity failure: %s", exc)
            continue
        if cand != path:
            logger.warning(
                "checkpoint %s is corrupt or missing — restored the newest "
                "intact retained file %s instead", path, cand)
        return payload
    raise CheckpointCorruptError(
        f"no intact checkpoint among {candidates} — every candidate failed "
        f"its integrity check")


def load_native(path: str) -> Dict[str, Any]:
    """A native checkpoint's payload, tensors on the CPU, from the newest
    intact file of ``path``'s chain. Raises ValueError for a file that is
    not one."""
    payload = read_payload(path)
    fmt = (payload.get("manifest") or {}).get("format") \
        if isinstance(payload, dict) else None
    if fmt != NATIVE_FORMAT:
        raise ValueError(
            f"{path} is not a native checkpoint of the port (format "
            f"{fmt!r}, expected {NATIVE_FORMAT!r})"
        )
    return payload
