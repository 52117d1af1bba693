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
the optimizer's state follows its parameter's). Under ``-t TP`` and
``-t FSDP`` the parameters and Adam's state are sharded; the strategy
gives the snapshot their whole tensors (``Strategy.model_state``,
``optimizer_state``: TP concatenates its channel slices on the host,
FSDP gathers each shard on every rank and rank 0 writes) and cuts a
restored whole tensor into its shards, so those files too hold the
singleGPU layout. The manifest's
``topology`` holds the JAX package's keys (``process_count``,
``device_count``, ``strategy``, ``mesh``, ``mesh_spec``, ``precision``).

A JAX ``.ckpt`` is one flax msgpack payload behind the JAX footer
(``DPT-SHA256:``), read and written here without flax or msgpack
(``ops/msgpack.py``). ``load_jax_ckpt`` turns it into the port's payload
and ``save_jax_ckpt`` a port payload into it, in both directions:

* the params through ``params_from_jax`` / ``params_to_jax`` (NHWC ↔
  NCHW kernels, the ConvTranspose flip), milesial's ``batch_stats`` as
  its running statistics;
* optax's ``inject_hyperparams(chain(add_decayed_weights,
  scale_by_adam, scale))`` state, ``count``, ``hyperparams.lr`` and
  ``inner_state."1".mu/nu``, as torch Adam's ``step``, ``exp_avg`` and
  ``exp_avg_sq`` of each parameter, each moment transformed as its
  parameter; under ``bf16_params`` (``topology.precision``) the
  ``MasterWeightsState`` ``{master, inner}`` as ``MasterWeights``'s
  ``{"master", "inner"}``;
* the scheduler, step, epoch, records and ``train_meta`` as they are
  (milesial's ``num_batches_tracked``, which flax does not keep, rides
  in ``train_meta``, so a round trip through a ``.ckpt`` is bitwise).

A JAX ``.int8.ckpt`` (``ops/quant.py``'s kind, msgpack) reads through the
same reader; ``quant_from_jax`` gives its weights under the port's names.
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

from distributedpytorch_tpu_torch.ops import msgpack
from distributedpytorch_tpu_torch.parallel.mesh import (
    canonical_spec,
    is_mesh_spec,
    parse_mesh_spec,
)

logger = logging.getLogger(__name__)

# ConvBlock map: JAX path prefix → reference tensor stem; the two convs
# of a block sit at Sequential indices 0/2.
_BLOCK_MAPS: Tuple[Tuple[Tuple[str, ...], str], ...] = tuple(
    [(("encoder", f"block{i}"), f"encoder.conv{i}") for i in range(1, 5)]
    + [(("mid",), "mid")]
    + [(("decoder", f"block{i}"), f"decoder.conv{i}") for i in range(1, 5)]
)


#: The native checkpoint's extension (``torch.save``), the JAX package's
#: (flax msgpack), and the formats the trainer's ``-c`` resolves, in order.
NATIVE_EXT = ".pt"
JAX_EXT = ".ckpt"
TRAIN_EXTS = (NATIVE_EXT, JAX_EXT, ".pth")
#: The native checkpoint's layout version, in its manifest.
NATIVE_FORMAT = "distributedpytorch_tpu_torch/native/1"


def resolve_checkpoint(name: str, checkpoint_dir: str = "./checkpoints",
                       exts: Sequence[str] = (".ckpt", ".pth")) -> str:
    """A checkpoint reference → an existing file path.

    Accepts an explicit path, a bare method name (``DP`` →
    ``<dir>/DP<ext>`` for each of ``exts`` in turn: ``.ckpt``, ``.pth``
    then ``.pt`` for serving, ``.pt``, ``.ckpt`` then ``.pth`` for the
    trainer), or a
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
        if ext in (NATIVE_EXT, JAX_EXT) and retained_checkpoints(cand):
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
    Another file raises: a JAX ``.ckpt`` loads with ``load_jax_ckpt``."""
    if not path.endswith(".pth"):
        raise ValueError(
            f"{path} is not a .pth file — reference-format weights only; "
            f"a JAX .ckpt loads with checkpoint.load_jax_ckpt"
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


def _kernel_to_torch(arr, transposed: bool):
    """JAX ``(kh, kw, I, O)`` → torch conv ``(O, I, kh, kw)``, or for a
    ConvTranspose ``(I, O, kh, kw)`` with a spatial flip: lax's transposed
    conv correlates with the mirrored kernel relative to torch's scatter
    form. Dropping the flip leaves every shape right and every output
    wrong. A numpy array or a tensor (a view)."""
    if isinstance(arr, torch.Tensor):
        if transposed:
            return arr.flip(0, 1).permute(2, 3, 0, 1)
        return arr.permute(3, 2, 0, 1)
    if transposed:
        return arr[::-1, ::-1].transpose(2, 3, 0, 1)
    return arr.transpose(3, 2, 0, 1)


def _kernel_from_torch(t: torch.Tensor, transposed: bool) -> torch.Tensor:
    """The inverse of ``_kernel_to_torch`` on a tensor (a view)."""
    if transposed:
        return t.permute(2, 3, 0, 1).flip(0, 1)
    return t.permute(2, 3, 1, 0)


def _is_transposed(path: Tuple[str, ...]) -> bool:
    """A ConvTranspose's kernel: the UNet's ``upconv<i>``, milesial's
    ``up``."""
    return path[-2] == "up" or path[-2].startswith("upconv")


def _flatten(tree, prefix=()) -> Dict[Tuple[str, ...], Any]:
    """Path tuple → array (a tensor stays one); a key may itself be a path
    tuple."""
    if isinstance(tree, Mapping):
        flat = {}
        for k, v in tree.items():
            flat.update(_flatten(v, prefix + (k if isinstance(k, tuple)
                                              else (k,))))
        return flat
    return {prefix: tree if isinstance(tree, torch.Tensor)
            else np.asarray(tree)}


def _nest(flat: Mapping[Tuple[str, ...], Any]) -> dict:
    """Path tuple → value, as the nested mapping flax writes."""
    out: dict = {}
    for path, value in flat.items():
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value
    return out


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
    """An owned CPU tensor: a tensor keeps its dtype, numpy becomes
    float32 (np.array copies: a device_get result may be read-only)."""
    if isinstance(arr, torch.Tensor):
        return arr.detach().cpu().contiguous().clone()
    return torch.from_numpy(np.array(arr, dtype=np.float32, order="C"))


def _maps_of(paths) -> Tuple[Dict[Tuple[str, ...], str],
                             Dict[Tuple[str, ...], str]]:
    """(params map, batch_stats map) of the model whose JAX param paths
    are ``paths``: milesial's when it has an ``inc`` block, the UNet's
    (no statistics) otherwise."""
    paths = list(paths)
    if not any(path[0] == "inc" for path in paths):
        return _name_map(), {}
    levels = 1 + len({path[0] for path in paths if path[0].startswith("down")})
    return _milesial_maps(levels)


def _named_from_jax(tree, pmap) -> Dict[str, torch.Tensor]:
    """A JAX params-shaped tree (the params, Adam's moments, the master)
    → ``{port name: tensor}``, every kernel in torch's layout."""
    out: Dict[str, torch.Tensor] = {}
    for path, arr in _flatten(tree).items():
        if path[-1] == "kernel":
            arr = _kernel_to_torch(arr, _is_transposed(path))
        out[pmap[path]] = _tensor(arr)
    return out


def params_from_jax(params, batch_stats=None) -> Dict[str, torch.Tensor]:
    """JAX weights — the nested mapping ``jax.device_get`` gives (numpy,
    made float32) or ``load_jax_ckpt``'s reader gives (tensors, dtypes
    kept), or a flat one keyed by path tuples — → the port's state dict:
    UNet params → ``UNet`` names; milesial params and ``batch_stats`` →
    upstream milesial names, the running statistics included and
    ``num_batches_tracked`` 0, as the JAX package's
    ``export_milesial_state_dict`` writes them."""
    pmap, smap = _maps_of(_flatten(params))
    out = _named_from_jax(params, pmap)
    if not smap:
        return out
    if batch_stats is None:
        raise ValueError("milesial params need their batch_stats")
    out.update(_stats_from_jax(batch_stats, smap))
    return out


def _stats_from_jax(batch_stats, smap) -> Dict[str, torch.Tensor]:
    """milesial's ``batch_stats`` → its running statistics under upstream
    names, ``num_batches_tracked`` 0 (flax keeps no count)."""
    out: Dict[str, torch.Tensor] = {}
    for path, arr in _flatten(batch_stats).items():
        name = smap[path]
        out[name] = _tensor(arr)
        out[name.rsplit(".", 1)[0] + ".num_batches_tracked"] = torch.tensor(
            0, dtype=torch.long)
    return out


def _maps_of_state(state: Mapping[str, Any]):
    """(params map, batch_stats map) of the model whose port state dict
    is ``state``."""
    if any(k.startswith("inc.") for k in state):
        return _milesial_maps(1 + len({k.split(".")[0] for k in state
                                       if k.startswith("down")}))
    return _name_map(), {}


def params_to_jax(state_dict: Mapping[str, torch.Tensor]):
    """The inverse of ``params_from_jax``: the port's state dict → ``(params,
    batch_stats)`` as the JAX package's trees, each kernel in flax's
    layout and every tensor in its own dtype on the CPU; ``batch_stats``
    is None for the UNet. Raises on a name that maps to no JAX path."""
    state = strip_module_prefix(state_dict)
    pmap, smap = _maps_of_state(state)
    by_name = {name: path for table in (pmap, smap)
               for path, name in table.items()}
    params, stats = {}, {}
    for name, value in state.items():
        if name.endswith(".num_batches_tracked"):
            continue
        path = by_name.get(name)
        if path is None:
            raise ValueError(f"{name!r} has no JAX counterpart")
        value = value.detach().cpu()
        if path[-1] == "kernel":
            value = _kernel_from_torch(value, _is_transposed(path))
        (stats if path in smap else params)[path] = value.contiguous()
    return _nest(params), (_nest(stats) if smap else None)


# -- native save/resume --------------------------------------------------------

_HASH_MAGIC = b"DPTSHA256"
#: the JAX package's footer (its checkpoint.py ``_HASH_MAGIC``)
_JAX_HASH_MAGIC = b"DPT-SHA256:"
#: what a ``torch.save`` archive starts with
_ZIP_MAGIC = b"PK\x03\x04"
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


def host_snapshot(model_state: Mapping[str, torch.Tensor],
                  optimizer_state: Mapping[str, Any], scheduler_state: dict,
                  step: int, epoch: int, records_state: Optional[dict],
                  manifest: Mapping[str, Any],
                  train_meta: Optional[dict] = None) -> Dict[str, Any]:
    """The trainer's full state as a payload of host tensors, taken now:
    the part of a save that must happen in the step loop's thread. The
    model's and the optimizer's state dicts are the singleGPU ones
    (``Strategy.model_state``, ``optimizer_state``), whole tensors under
    the reference names whatever the strategy sharded."""
    return {
        "model": _detached_copy(dict(model_state)),
        "optimizer": _detached_copy(optimizer_state),
        "scheduler": dict(scheduler_state),
        "step": int(step),
        "epoch": int(epoch),
        "records": records_state,
        "train_meta": dict(train_meta or {}),
        "manifest": {"format": NATIVE_FORMAT, **manifest},
    }


def _write_blob(path: str, blob: bytes, magic: bytes, keep: int) -> str:
    """``blob``, a footer of ``magic`` and its SHA-256, written to ``path``
    atomically (a uniquely named temporary file renamed into place),
    rotating the chain first so the previous file survives as ``path.1``
    and pruning it to ``keep`` files."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}.{next(_TMP_COUNTER)}"
    with open(tmp, "wb") as f:
        f.write(blob)
        f.write(magic)
        f.write(hashlib.sha256(blob).digest())
    with _RETENTION_LOCK:
        _rotate_retained(path, keep)
        os.replace(tmp, path)
        _prune_retained(path, keep)
    return path


def write_payload(path: str, payload: Mapping[str, Any], keep: int = 1
                  ) -> str:
    """Serialize ``payload`` with ``torch.save`` and write it with its hash
    footer (``_write_blob``), keeping ``keep`` files of the chain."""
    buf = io.BytesIO()
    torch.save(dict(payload), buf)
    return _write_blob(path, buf.getvalue(), _HASH_MAGIC, keep)


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


def _read_verified(path: str) -> Any:
    """One file's payload, its hash verified when it has a footer (the
    port's or the JAX package's; a file without one loads unverified):
    a ``torch.save`` archive (the port's files) or flax msgpack (a JAX
    ``.ckpt``, read by ``ops/msgpack.py``). A mismatch, an unreadable
    payload or msgpack that is not a map raises
    ``CheckpointCorruptError``."""
    with open(path, "rb") as f:
        blob = f.read()
    for magic in (_HASH_MAGIC, _JAX_HASH_MAGIC):
        n = len(magic) + 32
        if len(blob) > n and blob[-n:-32] == magic:
            body, digest = blob[:-n], blob[-32:]
            if hashlib.sha256(body).digest() != digest:
                raise CheckpointCorruptError(
                    f"{path}: content hash mismatch (torn write or bit rot)")
            blob = body
            break
    if blob[:4] != _ZIP_MAGIC:
        try:
            payload = msgpack.unpackb(blob)
        except msgpack.MsgpackError as exc:
            raise CheckpointCorruptError(
                f"{path}: unreadable payload: {exc}") from exc
        if not isinstance(payload, dict):
            raise CheckpointCorruptError(
                f"{path}: unreadable payload: msgpack "
                f"{type(payload).__name__}, not a map")
        return payload
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


# -- JAX .ckpt interchange -------------------------------------------------------

#: The JAX package's checkpoint layout version (its ``CKPT_VERSION``).
JAX_CKPT_VERSION = 1
_ADAM_BETAS = (0.9, 0.999)
_ADAM_EPS = 1e-8


def jax_topology(strategy: str, mesh: Mapping[str, int], precision: str
                 ) -> Dict[str, Any]:
    """The JAX manifest's ``topology`` of a run: ``save_topology``'s
    process and device counts and the strategy's name, ``mesh`` axes,
    ``mesh_spec`` and ``precision``. ``mesh_spec`` is JAX's
    ``canonical_spec``, ``DxMxS``, the model axis being a ``spatial`` one
    under SP and DDP_SP, marked ``@sp``, and the parameters sharded over
    the data axis under FSDP, marked ``@fsdp`` (JAX mesh.py:257-267).
    ``process_count`` is the mesh's data axis where each data row is a
    process (DDP, DDP_MP, DDP_SP, FSDP and every mesh spec). A mesh spec's
    ``strategy`` is its canonical spec, and so is its ``mesh_spec``
    (``2x2x1@fsdp`` for the ``fsdp+channel`` rule)."""
    mesh = {str(k): int(v) for k, v in mesh.items()}
    devices = int(np.prod(list(mesh.values()))) if mesh else 1
    if is_mesh_spec(strategy):
        cfg = parse_mesh_spec(strategy)
        return {
            "process_count": cfg.data,
            "device_count": devices,
            "strategy": strategy,
            "mesh": mesh,
            "mesh_spec": canonical_spec(cfg),
            "precision": precision,
        }
    processes = (mesh.get("data", 1)
                 if strategy in ("DDP", "DDP_MP", "DDP_SP", "FSDP") else 1)
    spatial = mesh.get("spatial", 1)
    model = spatial if spatial > 1 else mesh.get("model", 1)
    opts = ["sp"] if spatial > 1 else []
    if strategy == "FSDP":
        opts.append("fsdp")
    return {
        "process_count": processes,
        "device_count": devices,
        "strategy": strategy,
        "mesh": mesh,
        "mesh_spec": f"{mesh.get('data', 1)}x{model}x"
                     f"{mesh.get('stage', 1)}"
                     + ("@" + "+".join(opts) if opts else ""),
        "precision": precision,
    }


def _model_state_order(arch: str, params) -> Tuple[List[str], List[str]]:
    """``(state_dict keys, named_parameters names)`` of the port's model
    whose JAX params are ``params`` (widths read from the kernels), in the
    model's order, from a model built on the meta device."""
    from distributedpytorch_tpu_torch.config import TrainConfig
    from distributedpytorch_tpu_torch.models import create_model

    if arch == "milesial":
        widths = [params["inc"]["conv1"]["kernel"].shape[-1]]
        i = 1
        while f"down{i}" in params:
            widths.append(params[f"down{i}"]["conv"]["conv1"]["kernel"]
                          .shape[-1])
            i += 1
    else:
        widths, i = [], 1
        while f"block{i}" in params["encoder"]:
            widths.append(params["encoder"][f"block{i}"]["conv1"]["kernel"]
                          .shape[-1])
            i += 1
    with torch.device("meta"):
        model = create_model(TrainConfig(
            model_arch=arch, model_widths=tuple(int(w) for w in widths),
            s2d_levels=0, device="cpu", kernels="torch"))
    return (list(model.state_dict()),
            [name for name, _ in model.named_parameters()])


def _adam_from_jax(inject: Mapping[str, Any], pmap, names: Sequence[str],
                   lr: float, weight_decay: float) -> Dict[str, Any]:
    """optax's inject_hyperparams state → a torch Adam state dict over
    ``names`` (one param group; ``ops/optim.load_optimizer_state`` cuts
    it as the optimizer's groups)."""
    adam = inject["inner_state"]["1"]
    count = int(adam["count"])
    mu = _named_from_jax(adam["mu"], pmap)
    nu = _named_from_jax(adam["nu"], pmap)
    state = {} if count == 0 else {
        i: {"step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": mu[name], "exp_avg_sq": nu[name]}
        for i, name in enumerate(names)}
    return {"state": state, "param_groups": [{
        "lr": lr, "betas": _ADAM_BETAS, "eps": _ADAM_EPS,
        "weight_decay": weight_decay, "amsgrad": False, "maximize": False,
        "capturable": False, "differentiable": False,
        "params": list(range(len(names)))}]}


def _adam_to_jax(opt: Mapping[str, Any], names: Sequence[str],
                 like: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of ``_adam_from_jax``; a parameter without Adam state
    yet has zero moments, shaped as its entry of ``like``."""
    state = opt["state"]
    steps = [float(st["step"]) for st in state.values() if "step" in st]
    count = int(steps[0]) if steps else 0
    moments = {}
    for key in ("exp_avg", "exp_avg_sq"):
        moments[key] = {
            name: (state[i][key] if i in state else
                   torch.zeros(like[name].shape, dtype=torch.float32))
            for i, name in enumerate(names)}
    lr = opt["param_groups"][0]["lr"]
    counter = torch.tensor(count, dtype=torch.int32)
    return {
        "count": counter,
        "hyperparams": {"lr": torch.tensor(float(lr), dtype=torch.float32)},
        "hyperparams_states": {},
        "inner_state": {
            "0": {},
            "1": {"count": counter.clone(),
                  "mu": params_to_jax(moments["exp_avg"])[0],
                  "nu": params_to_jax(moments["exp_avg_sq"])[0]},
            "2": {},
        },
    }


def is_jax_payload(payload) -> bool:
    """Whether a decoded payload is a JAX checkpoint's (params, no port
    manifest)."""
    return (isinstance(payload, dict) and "params" in payload
            and "manifest" not in payload)


def payload_from_jax(raw: Mapping[str, Any], where: str = "checkpoint",
                     weight_decay: float = 1e-8) -> Dict[str, Any]:
    """A JAX checkpoint's payload (as the reader decodes it) → the port's
    native payload, tensors on the CPU in the saved dtypes, the model's
    state in its ``state_dict()`` order and Adam's state indexed in its
    ``named_parameters()`` order. The JAX file keeps no weight decay; the
    param groups carry ``weight_decay``."""
    if not is_jax_payload(raw) or not isinstance(raw["params"], dict):
        raise CheckpointCorruptError(
            f"{where}: not a JAX checkpoint payload (no params tree)")
    params = raw["params"]
    arch = "milesial" if "inc" in params else "unet"
    topology = dict(raw.get("topology") or {})
    # pre-policy checkpoints carried f32 params and a plain Adam state:
    # structurally the bf16 policy (JAX train/loop.py _restore)
    precision = topology.get("precision") or "bf16"
    meta = dict(raw.get("train_meta") or {})
    tracked = meta.pop("num_batches_tracked", None) or {}
    model = params_from_jax(params, raw.get("model_state"))
    for name, count in tracked.items():
        model[name] = torch.tensor(int(count), dtype=torch.long)
    order, names = _model_state_order(arch, params)
    ordered = {name: model[name] for name in order}
    pmap, _ = _maps_of(_flatten(params))
    scheduler = dict(raw.get("scheduler") or {})
    opt = raw.get("opt_state")
    optimizer = None
    if opt is not None:
        master = "master" in opt
        inject = opt["inner"] if master else opt
        lr = float(scheduler.get("lr", float(inject["hyperparams"]["lr"])))
        optimizer = _adam_from_jax(inject, pmap, names, lr, weight_decay)
        if master:
            masters = _named_from_jax(opt["master"], pmap)
            optimizer = {"master": [masters[n] for n in names],
                         "inner": optimizer}
    return {
        "model": ordered,
        "optimizer": optimizer,
        "scheduler": scheduler,
        "step": int(raw.get("step", 0)),
        "epoch": int(raw.get("epoch", 0)),
        "records": raw.get("records"),
        "train_meta": meta,
        "manifest": {
            "format": NATIVE_FORMAT,
            "model_arch": arch,
            "dtype": precision,
            "strategy": topology.get("strategy"),
            "world": int(topology.get("process_count", 1)),
            "topology": topology,
        },
    }


def payload_to_jax(payload: Mapping[str, Any]) -> Dict[str, Any]:
    """The inverse of ``payload_from_jax``: the port's native payload → the
    JAX package's checkpoint payload (what its ``_build_payload`` writes),
    the topology from the manifest's ``topology`` (or its strategy and
    world) with ``precision`` its ``dtype``."""
    manifest = dict(payload.get("manifest") or {})
    model = strip_module_prefix(payload["model"])
    params, stats = params_to_jax(model)
    param_names = set(_maps_of_state(model)[0].values())
    names = [n for n in model if n in param_names]
    precision = manifest.get("dtype") or "bf16"
    topology = dict(manifest.get("topology") or jax_topology(
        manifest.get("strategy") or "singleGPU",
        {"data": int(manifest["world"])} if manifest.get("world", 1) > 1
        else {}, precision))
    topology["precision"] = precision
    opt = payload.get("optimizer")
    opt_state = None
    if opt is not None:
        if "master" in opt:
            masters = dict(zip(names, opt["master"]))
            opt_state = {"master": params_to_jax(masters)[0],
                         "inner": _adam_to_jax(opt["inner"], names, masters)}
        else:
            opt_state = _adam_to_jax(opt, names, model)
    meta = dict(payload.get("train_meta") or {})
    tracked = {n: int(v) for n, v in model.items()
               if n.endswith(".num_batches_tracked")}
    if tracked:
        meta["num_batches_tracked"] = tracked
    return {
        "version": JAX_CKPT_VERSION,
        "topology": topology,
        "train_meta": meta,
        "params": params,
        "opt_state": opt_state,
        "scheduler": payload.get("scheduler"),
        "step": int(payload.get("step", 0)),
        "epoch": int(payload.get("epoch", 0)),
        "records": payload.get("records"),
        "model_state": stats,
    }


def load_jax_ckpt(path: str, weight_decay: float = 1e-8) -> Dict[str, Any]:
    """A JAX ``.ckpt`` → the port's payload (``payload_from_jax``), from
    the newest intact file of its chain (``x.ckpt``, ``x.ckpt.1``, …),
    each file's ``DPT-SHA256:`` footer verified as the JAX
    ``_read_verified`` does. Raises ``CheckpointCorruptError`` naming the
    path for a file that is not one."""
    return payload_from_jax(read_payload(path), where=path,
                            weight_decay=weight_decay)


def save_jax_ckpt(payload: Mapping[str, Any], path: str, keep: int = 1
                  ) -> str:
    """Write the port's payload as a JAX ``.ckpt`` (``payload_to_jax``,
    flax msgpack behind the JAX footer), rotating ``path``'s chain to
    ``keep`` files as the JAX writer does; the JAX ``Trainer`` resumes
    from it."""
    blob = msgpack.packb(payload_to_jax(payload))
    return _write_blob(path, blob, _JAX_HASH_MAGIC, keep)


def quant_from_jax(params: Mapping[str, Any], model_state=None):
    """A JAX int8 weights payload's ``params`` (flax tree, each quantized
    kernel ``{"q", "scale"}`` with the scale on the last axis) and
    ``model_state`` → ``(params, model_state)`` under the port's names as
    ``ops/quant.quantized_state`` gives them: ``q`` and ``scale`` each in
    torch's layout (the ConvTranspose's scale on axis 1), the running
    statistics with ``num_batches_tracked`` 0."""
    flat = _flatten(params)
    # a quantized kernel is a {"q", "scale"} map; BatchNorm's own "scale"
    # is a leaf with no "q" beside it
    quantized = {path[:-1] for path in flat if path[-1] == "q"}
    pmap, smap = _maps_of({path[:-1] if path[:-1] in quantized else path
                           for path in flat})
    out: Dict[str, Any] = {}
    for path, arr in flat.items():
        part = None
        if path[:-1] in quantized:
            path, part = path[:-1], path[-1]
        if path[-1] == "kernel":
            arr = _kernel_to_torch(arr, _is_transposed(path))
        value = _tensor(arr)
        if part is None:
            out[pmap[path]] = value
        else:
            out.setdefault(pmap[path], {})[part] = value
    return out, (None if model_state is None
                 else _stats_from_jax(model_state, smap))
