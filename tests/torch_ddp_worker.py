"""One rank of the port's data-parallel tests (``tests/test_torch_ddp.py``,
``tests/test_torch_ddp_mp.py``, ``tests/test_torch_isolation.py``), and
``launch``, which runs them.

    python tests/torch_ddp_worker.py JOB_DIR RANK WORLD

Imports torch and the port only, never jax. Joins a gloo group over a
file store in ``JOB_DIR`` (so parallel test runs share no port), reads
the scenarios of ``JOB_DIR/job.pt`` and runs each on the CPU, then writes
``JOB_DIR/result_<RANK>.pt``: a result per scenario, plus the jax-family
modules this process loaded. Scenarios:

* ``loss``: the sharded training loss (``ops/fused_loss.make_sharded_loss``)
  of this rank's rows of a global batch, and its gradient;
* ``steps``: train steps of a DDP-wrapped model from given weights; the
  gradients of the first step as the optimizer receives them (before
  Adam), each step's loss, the final state dict (and, under
  ``--dtype bf16_params``, the f32 master weights);
* ``accum``: one ``--grad-accum`` step over this rank's chunks; its loss
  and the gradients the optimizer receives;
* ``pipeline_steps``: train steps of ``-t DDP_MP`` (or the job's
  ``method``, ``DDP_SP``, ``FSDP`` or a mesh spec), the rank's S stages
  (or row shards, or channel slices) all on the CPU (or the job's
  ``device``, a card both ranks share), from given weights: as ``steps``
  (a channel-sharded model's gradients put together whole), with the
  state after
  every call (whole tensors, gathered under FSDP), each BatchNorm's
  ``global_stats`` flag, the strategy's devices, its mesh and lr, and the
  bytes of parameters and Adam's state this rank holds against the
  whole's (under ZeRO each channel slice's, under in-stage sharding each
  (stage, slice) place's, ``slice_bytes``), its name, under ``--dtype
  bf16_params`` the f32 masters (whole), and with the job's ``eval`` the
  eval step's metrics on the first batch after the steps.
  With the config's ``steps_per_dispatch`` K > 1 the batches go through
  the strategy's multi-step in stacks of K, with its ``grad_accum`` N > 1
  through its accumulation step in chunks of N; with the job's ``count``
  the steps' collectives, ZeRO gathers and reductions and recomputes
  (``_counting``);
* ``trainer``: ``Trainer`` under ``-t DDP`` (or the job's ``method``) for
  its epochs; the losses, the val metrics, the lr, the final state dict
  and what each rank wrote into a directory of its own; how many
  ``DistributedDataParallel`` wrappers it built and how many forwards
  they ran; and whether its K-step dispatch drives its own train step;
* ``cli``: ``cli.main`` on every rank over the joined group (it leaves
  the group, so the ``cli`` scenarios run last; each past the first joins
  a group of its own first);
* ``preempt``: ``Trainer`` under ``-t DDP`` whose train step raises
  SIGTERM on the ranks and after the global steps ``job["signal"]``
  names, or adds one to a rank's step count (``job["skew"]``); what each
  rank ran, the errors it logged, whether the handler was put back, and
  what rank 0 saved; the ranks meet at a barrier before the next
  scenario reads the file.
"""

import contextlib
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
# the bound on one multi-process run of a test
LAUNCH_TIMEOUT_S = 120


def launch(job_dir, jobs, world=2, timeout=LAUNCH_TIMEOUT_S):
    """Run ``jobs`` (scenario name → spec) on ``world`` ranks of this
    script; their results, by rank. A rank that fails or outlives
    ``timeout`` fails the caller."""
    os.makedirs(job_dir, exist_ok=True)
    torch.save(jobs, os.path.join(job_dir, "job.pt"))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(job_dir), str(rank),
         str(world)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for rank in range(world)]
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=timeout)[0].decode())
    finally:
        for proc in procs:
            proc.kill()
    for rank, proc in enumerate(procs):
        assert proc.returncode == 0, f"rank {rank}:\n{logs[rank][-4000:]}"
    return [torch.load(os.path.join(job_dir, f"result_{rank}.pt"),
                       weights_only=False) for rank in range(world)]


def _rows(array, rank, world):
    """This rank's equal share of the leading axis, as a tensor."""
    per = array.shape[0] // world
    return torch.from_numpy(array[rank * per:(rank + 1) * per].copy())


def run_loss(job, rank, world):
    from distributedpytorch_tpu_torch.ops.fused_loss import make_sharded_loss

    preds = _rows(job["preds"], rank, world).requires_grad_(True)
    loss = make_sharded_loss(job["fused"])(preds, _rows(job["target"], rank,
                                                       world))
    loss.backward()
    return {"loss": loss.detach(), "grad": preds.grad}


def _first_step_grads(optimizer, names, whole=None):
    """``{name: gradient}`` as the optimizer's first step reads them (under
    master weights the scaled f32 ones Adam reads), filled by a step
    pre-hook when that step runs. ``whole`` (a channel-sharded model's
    ``whole_values``, a collective under ZeRO) puts the parameters'
    gradients together as the whole tensors ``names`` name."""
    grads = {}

    def hook(opt, _args, _kwargs):
        if not grads:
            params = [p for g in opt.param_groups for p in g["params"]]
            if whole is not None:
                grads.update(zip(names, whole([p.grad for p in params])))
                return
            # an FSDP shard's gradient, gathered whole on every rank
            grads.update({n: (p.grad.full_tensor()
                              if hasattr(p.grad, "full_tensor")
                              else p.grad.clone())
                          for n, p in zip(names, params)})

    optimizer.register_step_pre_hook(hook)
    return grads


def run_steps(job, rank, world):
    from distributedpytorch_tpu_torch.config import TrainConfig
    from distributedpytorch_tpu_torch.models import create_model
    from distributedpytorch_tpu_torch.ops.optim import make_optimizer
    from distributedpytorch_tpu_torch.ops.precision import (
        cast_params_,
        get_policy,
    )
    from distributedpytorch_tpu_torch.parallel.strategy import build_strategy
    from distributedpytorch_tpu_torch.train.steps import make_train_step

    cfg = TrainConfig(train_method="DDP", device="cpu", **job["config"])
    strategy = build_strategy(cfg)
    policy = get_policy(cfg)
    # the master (bf16_params) is seeded from the f32 weights, then the
    # parameters are rounded, as the trainer does
    model = create_model(cfg, cast_params=False)
    model.load_state_dict(job["initial"])
    optimizer = make_optimizer(model.parameters(),
                               strategy.lr_for(cfg.learning_rate),
                               cfg.weight_decay, policy=policy)
    cast_params_(model, policy)
    wrapped = strategy.wrap_model(model, optimizer)
    grads = _first_step_grads(optimizer, [n for n, _ in
                                          model.named_parameters()])
    step = make_train_step(
        wrapped, optimizer, cfg.batch_size, cfg.faithful_loss_scaling,
        loss_impl=strategy.train_loss(job["fused"]))
    losses = []
    for batch in job["batches"]:
        losses.append(step({k: _rows(v, rank, world)
                            for k, v in batch.items()}))
    return {"losses": torch.stack(losses), "grads": grads,
            "state": {k: v.clone() for k, v in model.state_dict().items()},
            "master": [m.clone() for m in getattr(optimizer, "master", ())]}


def run_pipeline_steps(job, rank, world):
    from distributedpytorch_tpu_torch.config import TrainConfig
    from distributedpytorch_tpu_torch.models import create_model
    from distributedpytorch_tpu_torch.models.milesial import BatchNormAct
    from distributedpytorch_tpu_torch.ops.kernels import get_kernel_policy
    from distributedpytorch_tpu_torch.ops.optim import make_optimizer
    from distributedpytorch_tpu_torch.ops.precision import (
        cast_params_,
        get_policy,
    )
    from distributedpytorch_tpu_torch.parallel.strategy import (
        build_strategy,
        gathered,
    )

    device = job.get("device", "cpu")
    cfg = TrainConfig(train_method=job.get("method", "DDP_MP"),
                      device=device, **job["config"])
    strategy = build_strategy(cfg)
    policy = get_policy(cfg)
    # as run_steps: the master seeded from the f32 weights, then the
    # parameters rounded
    model = create_model(cfg, cast_params=False)
    model.load_state_dict(job["initial"])
    model = strategy.place_model(model)
    optimizer = make_optimizer(model.parameters(),
                               strategy.lr_for(cfg.learning_rate),
                               cfg.weight_decay, policy=policy)
    cast_params_(model, policy)
    if hasattr(model, "whole_values"):
        # channel slices (and their ZeRO pieces): the whole gradients
        grads = _first_step_grads(optimizer, model.whole_param_names(),
                                  model.whole_values)
    else:
        grads = _first_step_grads(optimizer, [n for n, _ in
                                              model.named_parameters()])
    kernels = get_kernel_policy(cfg.kernels)
    step = strategy.build_train_step(model, optimizer, kernels)
    batches = [{k: _rows(v, rank, world).to(strategy.device)
                for k, v in batch.items()} for batch in job["batches"]]
    size = 1
    if cfg.steps_per_dispatch > 1:
        size = cfg.steps_per_dispatch
        multi = strategy.build_multi_train_step(step)

        def run(group):
            return multi({k: torch.stack([b[k] for b in group])
                          for k in group[0]})
    elif cfg.grad_accum > 1:
        size = cfg.grad_accum
        accum = strategy.build_accum_train_step(model, optimizer, kernels)

        def run(group):
            return accum(group).reshape(1)
    else:
        def run(group):
            return step(group[0]).reshape(1)
    losses, states = [], []
    counts = _new_counts()
    for i in range(0, len(batches), size):
        with (_counting(counts) if job.get("count")
              else contextlib.nullcontext()):
            losses.append(run(batches[i:i + size]))
        states.append({k: v.clone() for k, v in
                       strategy.model_state(model).items()})
    metrics = None
    if job.get("eval"):
        metrics = strategy.build_eval_step(model, kernels)(batches[0])
    masters = list(getattr(optimizer, "master", ()))
    return {"losses": torch.cat(losses), "grads": grads, "eval": metrics,
            "states": states, "bytes": _state_bytes(model, optimizer),
            "lr": strategy.lr_for(cfg.learning_rate),
            # whole, as the states (an FSDP master is a shard, a channel
            # slice's or a ZeRO piece's is put together)
            "master": ([m.detach().clone() for m in
                        model.whole_values(masters)]
                       if masters and hasattr(model, "whole_values")
                       else [gathered(m).detach().clone() for m in masters]),
            "global_stats": sorted({m.global_stats for m in model.modules()
                                    if isinstance(m, BatchNormAct)}),
            "devices": [str(d) for d in strategy.step_devices],
            "counts": counts if job.get("count") else None,
            "mesh": strategy.mesh_shape(), "name": strategy.name,
            "slice_bytes": _slice_bytes(model, optimizer)}


def _slice_bytes(model, optimizer):
    """Under ZeRO and in-stage sharding (``parallel/zero.ZeroSharded``):
    the bytes of parameters and Adam's state this rank holds on each
    place (under master weights with each f32 master and Adam's state over
    it), a channel slice (a layer kept whole counts on slice 0), or
    in a pipeline stage ``(stage, slice)``; how many elements of the
    wrapped model's parameters are whole between steps (none: only the
    pieces stay); in a pipeline, each stage's whole bytes
    (``stage_bytes``, the whole tensors and their two moments) and each
    place's bytes of parameters kept whole (``kept_whole``); else
    None."""
    import re

    if not hasattr(model, "paths"):
        return None
    stage_of = getattr(model, "stage_of", None)
    masters = dict(zip(getattr(optimizer, "params", ()),
                       getattr(optimizer, "master", ())))
    held, kept, stages = {}, {}, {}
    for j, owner in enumerate(model._owners):
        for k, i in enumerate(owner.pieces):
            p = model.pieces[i]
            if stage_of is None:
                found = re.search(r"\.shards\.(\d+)\.", model.paths[i])
                place = int(found.group(1)) if found else 0
            else:
                place = (stage_of[j], k)
            owners = [p] + ([masters[p]] if p in masters else [])
            tensors = owners + [t for o in owners
                                for t in optimizer.state[o].values()
                                if isinstance(t, torch.Tensor) and t.dim() > 0]
            nbytes = sum(t.numel() * t.element_size() for t in tensors)
            held[place] = held.get(place, 0) + nbytes
            if owner.cut is None:
                kept[place] = kept.get(place, 0) + nbytes
        if stage_of is not None:
            whole = 3 * torch.Size(owner.shape).numel() * 4
            stages[stage_of[j]] = stages.get(stage_of[j], 0) + whole
    leaves = sum(getattr(o.module, o.attr).numel() for o in model._owners
                 if o.cut and getattr(o.module, o.attr) is not None)
    return {"held": held, "whole_leaves": leaves, "kept_whole": kept,
            "stage_bytes": stages}


def _state_bytes(model, optimizer):
    """``(mine, whole)``: the bytes of parameters and Adam's state this
    rank holds (an FSDP shard's local part) and the whole state's; under
    master weights each parameter's f32 master and Adam's state over the
    master count with it."""
    def local(t):
        return t.to_local() if hasattr(t, "to_local") else t

    def nbytes(t):
        return t.numel() * t.element_size()

    masters = dict(zip(getattr(optimizer, "params", ()),
                       getattr(optimizer, "master", ())))
    mine = whole = 0
    for p in model.parameters():
        owners = [p] + ([masters[p]] if p in masters else [])
        tensors = owners + [t for o in owners
                            for t in optimizer.state[o].values()
                            if isinstance(t, torch.Tensor) and t.dim() > 0]
        mine += sum(nbytes(local(t)) for t in tensors)
        whole += sum(nbytes(t) for t in tensors)
    return mine, whole


def _new_counts():
    return {"all_reduce": 0, "all_gather_into_tensor": 0,
            "reduce_scatter_tensor": 0, "summed_dtypes": set(),
            "gathers": 0, "reductions": 0, "recomputes": 0}


@contextlib.contextmanager
def _counting(counts):
    """Within the block ``counts`` (``_new_counts``) counts the
    collectives this process issues, by name, and the dtypes of the
    tensors its sums over ranks (all-reduce, reduce-scatter) take; the
    ZeRO gathers and reductions (``zero.ZeroSharded.gather_`` and
    ``reduce_grads_``); and the recomputes (``models.recomputing``
    entered)."""
    import torch.distributed as dist

    from distributedpytorch_tpu_torch import models
    from distributedpytorch_tpu_torch.parallel.zero import ZeroSharded

    saved = {name: getattr(dist, name) for name in (
        "all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor")}
    methods = {"gathers": ZeroSharded.gather_,
               "reductions": ZeroSharded.reduce_grads_}
    recomputing = models.recomputing

    def collective(name):
        def counted(*args, **kwargs):
            counts[name] += 1
            if name != "all_gather_into_tensor":
                counts["summed_dtypes"].add(str(args[0].dtype))
            return saved[name](*args, **kwargs)
        return counted

    def method(key):
        def counted(self, *args, **kwargs):
            counts[key] += 1
            return methods[key](self, *args, **kwargs)
        return counted

    @contextlib.contextmanager
    def counted_recomputing(module):
        counts["recomputes"] += 1
        with recomputing(module):
            yield

    for name in saved:
        setattr(dist, name, collective(name))
    ZeroSharded.gather_ = method("gathers")
    ZeroSharded.reduce_grads_ = method("reductions")
    models.recomputing = counted_recomputing
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)
        ZeroSharded.gather_ = methods["gathers"]
        ZeroSharded.reduce_grads_ = methods["reductions"]
        models.recomputing = recomputing


@contextlib.contextmanager
def _counting_ddp(counts):
    """Within the block, ``counts`` (``{"built": 0, "forwards": 0}``)
    counts the ``DistributedDataParallel`` wrappers built in this process
    and the forwards they run."""
    from torch.nn.parallel import DistributedDataParallel as DDP

    init, forward = DDP.__init__, DDP.forward

    def counted_init(self, *args, **kwargs):
        counts["built"] += 1
        init(self, *args, **kwargs)

    def counted_forward(self, *args, **kwargs):
        counts["forwards"] += 1
        return forward(self, *args, **kwargs)

    DDP.__init__, DDP.forward = counted_init, counted_forward
    try:
        yield
    finally:
        DDP.__init__, DDP.forward = init, forward


def run_accum(job, rank, world):
    from distributedpytorch_tpu_torch.config import TrainConfig
    from distributedpytorch_tpu_torch.models import create_model
    from distributedpytorch_tpu_torch.parallel.strategy import build_strategy
    from distributedpytorch_tpu_torch.train.steps import (
        make_accum_train_step,
    )

    cfg = TrainConfig(train_method="DDP", device="cpu", **job["config"])
    strategy = build_strategy(cfg)
    model = create_model(cfg)
    model.load_state_dict(job["initial"])
    optimizer = torch.optim.SGD(model.parameters(), lr=0.0)
    grads = _first_step_grads(optimizer, [n for n, _ in
                                          model.named_parameters()])
    step = make_accum_train_step(
        model, optimizer, cfg.batch_size, cfg.grad_accum,
        cfg.faithful_loss_scaling, job["fused"],
        sum_over_ranks=strategy.sum_over_ranks)
    loss = step([{k: _rows(v, rank, world) for k, v in chunk.items()}
                 for chunk in job["chunks"]])
    return {"loss": loss, "grads": grads}


def run_trainer(job, rank, world):
    from distributedpytorch_tpu_torch.config import TrainConfig
    from distributedpytorch_tpu_torch.ops.optim import get_learning_rate
    from distributedpytorch_tpu_torch.train.loop import Trainer

    counts = {"built": 0, "forwards": 0}
    out = os.path.join(job["dir"], f"rank{rank}")
    cfg = TrainConfig(
        train_method=job.get("method", "DDP"), device="cpu",
        checkpoint_dir=os.path.join(out, "checkpoints"),
        log_dir=os.path.join(out, "logs"),
        loss_dir=os.path.join(out, "loss"), **job["config"])
    with _counting_ddp(counts):
        trainer = Trainer(cfg, initial_state=job["initial"])
        result = trainer.train()
    resumed_from = None
    if cfg.checkpoint_name and not cfg.checkpoint_name.endswith(".pth"):
        payload = torch.load(cfg.checkpoint_name, weights_only=True)
        resumed_from = {k: payload[k] for k in ("manifest", "epoch", "step",
                                                "scheduler")}
    manifest = None
    if trainer.strategy.is_main:
        manifest = torch.load(trainer.checkpoint_path,
                              weights_only=True)["manifest"]
    return {
        "ddp": counts, "same_step": (trainer.multi_step is not None and
                                     trainer.multi_step.step
                                     is trainer.train_step),
        "resumed_from": resumed_from, "manifest": manifest,
        "losses": [float(x) for x in trainer.records.losses],
        "result": result,
        "lr": get_learning_rate(trainer.optimizer),
        # whole tensors on every rank (an FSDP gather every rank enters)
        "state": {k: v.clone() for k, v in
                  trainer.strategy.model_state(trainer.model).items()},
        "wrote": sorted(os.path.relpath(os.path.join(d, f), out)
                        for d, _, files in os.walk(out) for f in files),
        "out": out,
    }


def run_preempt(job, rank, world):
    import logging
    import signal

    from distributedpytorch_tpu_torch.checkpoint import load_native
    from distributedpytorch_tpu_torch.config import TrainConfig
    from distributedpytorch_tpu_torch.train.loop import Trainer

    out = os.path.join(job["dir"], f"rank{rank}")
    ckpt_dir = os.path.join(job["dir"], "checkpoints")
    cfg = TrainConfig(train_method="DDP", device="cpu",
                      checkpoint_dir=ckpt_dir,
                      log_dir=os.path.join(out, "logs"),
                      loss_dir=os.path.join(out, "loss"), **job["config"])
    errors = []

    class Errors(logging.Handler):
        def emit(self, record):
            errors.append(record.getMessage())

    handler = Errors(logging.ERROR)
    logging.getLogger().addHandler(handler)
    trainer = Trainer(cfg)
    real = trainer.train_step
    signal_at = job.get("signal", {}).get(rank)
    skew_at = job.get("skew", {}).get(rank)

    def step(batch):
        loss = real(batch)
        if trainer.step + 1 == signal_at:
            signal.raise_signal(signal.SIGTERM)
        if trainer.step + 1 == skew_at:
            trainer.step += 1
        return loss

    trainer.train_step = step
    try:
        result = trainer.train()
    finally:
        logging.getLogger().removeHandler(handler)
    saved = None
    if trainer.strategy.is_main:
        payload = load_native(trainer.checkpoint_path)
        saved = {"epoch": payload["epoch"], "step": payload["step"],
                 "files": sorted(os.listdir(ckpt_dir))}
    torch.distributed.barrier()
    return {"result": result, "errors": errors, "saved": saved,
            "handler_restored": signal.getsignal(signal.SIGTERM)
            == signal.SIG_DFL}


def run_cli(job, rank, world):
    """``cli.main(job["argv"])`` on every rank, in ``job["dir"]``, over the
    group this process already joined (``start_runtime`` takes it as it
    is; the CLI's shutdown at its end leaves it, so it runs last); what
    the ranks wrote there and rank 0's manifest."""
    import logging

    from distributedpytorch_tpu_torch import cli
    from distributedpytorch_tpu_torch.checkpoint import load_native

    if not torch.distributed.is_initialized():
        # an earlier ``cli`` scenario left the group: a new one, over a
        # file store of this scenario's
        os.makedirs(job["dir"], exist_ok=True)
        torch.distributed.init_process_group(
            "gloo", init_method=f"file://{os.path.join(job['dir'], 'store')}",
            rank=rank, world_size=world)
    out = os.path.join(job["dir"], f"rank{rank}")
    os.makedirs(out, exist_ok=True)
    cwd = os.getcwd()
    root = logging.getLogger()
    before = list(root.handlers)
    os.chdir(out)
    try:
        code = cli.main(job["argv"])
    finally:
        os.chdir(cwd)
        for handler in set(root.handlers) - set(before):
            root.removeHandler(handler)
            handler.close()
    method = job["argv"][job["argv"].index("-t") + 1]
    ckpt = os.path.join(out, "checkpoints", f"{method}.pt")
    return {"code": code, "out": out,
            "wrote": sorted(os.path.relpath(os.path.join(d, f), out)
                            for d, _, files in os.walk(out) for f in files),
            "manifest": (load_native(ckpt)["manifest"]
                         if os.path.exists(ckpt) else None)}


SCENARIOS = {"loss": run_loss, "steps": run_steps, "accum": run_accum,
             "pipeline_steps": run_pipeline_steps, "trainer": run_trainer,
             "preempt": run_preempt, "cli": run_cli}


def main():
    job_dir, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    torch.set_num_threads(1)
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{os.path.join(job_dir, 'store')}",
        rank=rank, world_size=world)
    try:
        jobs = torch.load(os.path.join(job_dir, "job.pt"), weights_only=False)
        results = {name: SCENARIOS[job["kind"]](job, rank, world)
                   for name, job in jobs.items()}
    finally:
        # a ``cli`` scenario's run has left the group already
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    results["leaked"] = sorted(
        name for name in sys.modules
        if name in ("jax", "flax", "distributedpytorch_tpu")
        or name.startswith(("jax.", "jaxlib", "flax.",
                            "distributedpytorch_tpu.")))
    torch.save(results, os.path.join(job_dir, f"result_{rank}.pt"))


if __name__ == "__main__":
    main()
