"""The port on the card: the serve-mask kernel, the loss statistics
kernels, the BatchNorm epilogue kernels and the 9-tap weight-gradient
kernel against their plain versions, the wrappers' refusals, a small
engine's streams, masks and bucket graphs (replay against the eager
forward, two replays of one bucket in flight, int8 bytes on the card,
quantization on the card against the host), UNet and milesial train
steps under both kernel policies, the DDP loss and step at world 1 under
NCCL, the DDP_MP pipeline's seams at world 1, SP's K-step graph and
``--remat`` on repeated devices, the kernel probes and a
priors file's effect, the profiler window's trace of the loss kernels
(eager and in a CUDA graph), and a ``.ckpt`` round trip resumed on the
card. Every test carries
the ``cuda`` marker and skips without a card; this file imports nothing
of JAX, so the card's machine runs it as it is:

    python -m pytest -m cuda tests/test_torch_cuda.py
"""

import re
import threading

import numpy as np
import pytest
import torch

from distributedpytorch_tpu_torch.ops import kernels
from distributedpytorch_tpu_torch.ops.kernels import (
    sigmoid_threshold_mask,
    sigmoid_threshold_mask_reference,
)

pytestmark = pytest.mark.cuda


def _traced(fn, symbol):
    """``(fn(), n)``: n is how many kernels named ``symbol`` the card ran
    during the call, by the profiler's trace."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, sum(bool(re.search(rf"\b{symbol}\b", evt.name))
                    for evt in prof.events()
                    if evt.device_type == torch.autograd.DeviceType.CUDA)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("shape", [(8, 640, 960), (3, 17, 29), (5,)])
def test_kernel_matches_plain_version(cuda_device, shape):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    p = torch.rand(shape, generator=gen, device=cuda_device)
    p.view(-1)[::7] = 0.5
    before = kernels.LAUNCHES["serve_mask"]
    got = sigmoid_threshold_mask(p, 0.5)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["serve_mask"] == before + 1
    assert torch.equal(got, sigmoid_threshold_mask_reference(p, 0.5))
    z = torch.randn(shape, generator=gen, device=cuda_device) * 4
    flips = (sigmoid_threshold_mask(z, 0.5, from_logits=True)
             != sigmoid_threshold_mask_reference(z, 0.5, from_logits=True))
    # __expf vs torch.sigmoid: a few ulp, only at the threshold
    assert not (flips & ((torch.sigmoid(z) - 0.5).abs() >= 1e-6)).any()


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    x = torch.rand(4, 8, device=cuda_device)
    with pytest.raises(ValueError, match="float32"):
        sigmoid_threshold_mask(x.half(), 0.5)
    with pytest.raises(ValueError, match="contiguous"):
        sigmoid_threshold_mask(x.t(), 0.5)
    with pytest.raises(ValueError, match="aligned"):
        sigmoid_threshold_mask(x.view(-1)[1:], 0.5)


def test_engine_masks_on_the_card(cuda_device):
    """A small bf16 engine under both policies: the cuda policy's uint8
    masks equal the torch policy's host threshold away from 0.5, and a
    row padded into a larger bucket keeps its probabilities within 1e-3
    (cuDNN may pick another algorithm per bucket shape)."""
    from distributedpytorch_tpu_torch.models.unet import UNet
    from distributedpytorch_tpu_torch.serve.engine import ServeEngine

    model = UNet(widths=(8, 16), generator=torch.Generator().manual_seed(0))
    common = dict(input_hw=(64, 96), bucket_sizes=(1, 4), device="cuda")
    masked = ServeEngine(model, kernels="cuda", **common)
    plain = ServeEngine(model, kernels="torch", **common)
    batch = np.random.default_rng(0).random((3, 64, 96, 3), np.float32)
    # the bucket forward is a CUDA graph: its replay launches the kernel
    # without the wrapper, so the launch is counted in the trace
    got, traced = _traced(lambda: masked.infer(batch), "serve_mask_kernel")
    assert traced == 1
    probs = plain.infer(batch)
    assert got.dtype == np.uint8 and probs.dtype == np.float32
    diff = got != plain.postprocess(probs)
    assert not (diff & (np.abs(probs - 0.5) >= 1e-3)).any()
    solo = plain.infer(batch[:1])
    np.testing.assert_allclose(probs[0], solo[0], rtol=0, atol=1e-3)


@pytest.fixture
def deterministic_cudnn(cuda_device):
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield cuda_device
    torch.backends.cudnn.deterministic = saved


@pytest.mark.parametrize("policy", ["cuda", "torch"])
def test_bucket_graphs_replay_the_eager_forward_bitwise(deterministic_cudnn,
                                                        policy):
    """Every (replica, bucket) forward is a CUDA graph, captured at build;
    its replay equals the eager forward bit for bit under cuDNN's
    deterministic algorithms, milesial's K2 and K4 inside it."""
    from distributedpytorch_tpu_torch.models.milesial import MilesialUNet
    from distributedpytorch_tpu_torch.models.unet import UNet
    from distributedpytorch_tpu_torch.serve.engine import ServeEngine

    gen = torch.Generator(device=deterministic_cudnn).manual_seed(1)
    for model in (UNet(widths=(8, 16)), MilesialUNet(widths=(8, 16))):
        engine = ServeEngine(model, input_hw=(64, 96), bucket_sizes=(1, 2, 4),
                             kernels=policy, device="cuda")
        assert engine.graph_captures == 3
        assert engine.aot_cache_stats["compiles"] == 3
        replica = engine.replicas[0]
        for b, forward in replica.compiled.items():
            assert forward.graph is not None
            x = torch.rand((b, 64, 96, 3), generator=gen,
                           device=deterministic_cudnn)
            eager = forward.eager(x)
            graph = forward(x)
            torch.cuda.synchronize()
            assert torch.equal(eager, graph), (type(model).__name__, b)


def test_two_inflight_replays_of_one_bucket_keep_their_results(
        deterministic_cudnn):
    """The same bucket dispatched twice before either result is drained:
    each result is its own buffer, the second replay leaves the first
    intact."""
    from distributedpytorch_tpu_torch.models.unet import UNet
    from distributedpytorch_tpu_torch.serve.engine import ServeEngine

    engine = ServeEngine(UNet(widths=(8, 16)), input_hw=(64, 96),
                         bucket_sizes=(2,), kernels="torch", device="cuda")
    replica = engine.replicas[0]
    rng = np.random.default_rng(2)
    batches = [rng.random((2, 64, 96, 3), np.float32) for _ in range(2)]
    results = [engine.run(replica, engine.place(replica, b))
               for b in batches]
    got = [r.numpy() for r in results]
    assert not np.array_equal(got[0], got[1])
    for batch, probs in zip(batches, got):
        x = torch.from_numpy(batch).to(deterministic_cudnn)
        want = replica.compiled[2].eager(x).cpu().numpy()
        np.testing.assert_array_equal(probs, want)


def test_quantization_on_the_card_equals_the_host(cuda_device):
    """q and scales computed on the card are the host's bit for bit (the
    converter quantizes on the card, serve's quantize-on-load on the
    host)."""
    from distributedpytorch_tpu_torch.ops.quant import quantize_weight

    gen = torch.Generator().manual_seed(4)
    for shape, axis in (((64, 32, 3, 3), 0), ((32, 16, 2, 2), 1)):
        w = torch.randn(shape, generator=gen) * 0.05
        q_host, s_host = quantize_weight(w, axis)
        q_card, s_card = quantize_weight(w.to(cuda_device), axis)
        assert torch.equal(q_card.cpu(), q_host)
        assert torch.equal(s_card.cpu(), s_host)


def test_int8_replica_holds_int8_bytes_on_the_card(cuda_device):
    """The full-width UNet's int8 replica holds under 0.3 of the float
    replica's bytes on the card, no float conv weight is there, and
    placing its model on the card (a copy, as the engine's replica build
    copies it) allocates under half of the float weights' bytes (the
    caching allocator may hand out a block up to 1 MB larger than asked,
    so the allocation itself is not held to 0.3)."""
    import copy

    from distributedpytorch_tpu_torch.models.unet import UNet
    from distributedpytorch_tpu_torch.serve.engine import ServeEngine

    model = UNet()
    common = dict(input_hw=(64, 96), bucket_sizes=(1,), device="cuda")
    float_engine = ServeEngine(model, **common)
    int8_engine = ServeEngine(model, quantized=True, **common)
    replica = int8_engine.replicas[0]

    def storage(r):
        tensors = r.model.state_dict().values()
        assert all(t.is_cuda for t in tensors)
        return sum(t.untyped_storage().nbytes() for t in tensors)

    float_bytes = storage(float_engine.replicas[0])
    assert storage(replica) / float_bytes < 0.3
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated(cuda_device)
    placed = copy.deepcopy(replica.model)
    torch.cuda.synchronize(cuda_device)
    assert torch.cuda.memory_allocated(cuda_device) - before \
        < 0.5 * float_bytes
    del placed
    # the only 4-d float tensors are the per-out-channel scales
    assert all(name.endswith(".scale")
               for name, t in replica.model.state_dict().items()
               if t.is_floating_point() and t.ndim == 4)
    x = np.random.default_rng(3).random((1, 64, 96, 3), np.float32)
    assert int8_engine.infer(x).shape == (1, 64, 96)


# -- the loss statistics kernel (K1) and its backward (K1-bwd) -----------------


def _loss_inputs(shape, device, seed=0):
    """p with exact 0.0 / 1.0 pixels, pixels at 0.5 and just below it and
    subnormal ones; t in {0, 1, 255} (255 binarizes to 0)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    p = torch.rand(shape, generator=gen, device=device)
    flat = p.view(-1)
    for start, value in ((0, 0.0), (1, 1.0), (2, 0.5), (3, 0.49999997),
                         (4, 1e-40), (5, 1e-45)):
        flat[start::11] = value
    t = torch.randint(0, 3, shape, generator=gen, device=device).float()
    t[t == 2] = 255.0
    # at least one saturated pixel at any size: p = 0 where t = 1
    t.view(-1)[0] = 1.0
    return p, t


@pytest.mark.parametrize("shape", [(4, 640, 960, 1), (3, 17, 29, 1), (5,)])
def test_loss_stats_kernel_matches_plain_version(cuda_device, shape):
    from distributedpytorch_tpu_torch.ops import loss_kernels as lk

    p, t = _loss_inputs(shape, cuda_device)
    before = kernels.LAUNCHES["loss_stats"]
    got = lk.eval_stats(p, t)
    again = lk.eval_stats(p, t)
    want = lk.eval_stats_reference(p, t)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["loss_stats"] == before + 2
    # float sums in other orders: rel 1e-5; count and hard sums exact
    torch.testing.assert_close(got[[0, 2, 3]], want[[0, 2, 3]], rtol=1e-5,
                               atol=0)
    assert torch.equal(got[[1, 4, 5]], want[[1, 4, 5]])
    assert torch.equal(got, again)  # no atomics: bitwise repeatable


def _assert_stats_match(got, want):
    """Soft sums within rel 1e-5 (float32 sums in other orders), the count
    and hard sums exact."""
    torch.testing.assert_close(got[[0, 2, 3]], want[[0, 2, 3]], rtol=1e-5,
                               atol=0)
    assert torch.equal(got[[1, 4, 5]], want[[1, 4, 5]])


@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 1023, 1025, 2**20 + 3,
                               4 * 640 * 960])
def test_loss_stats_kernel_at_the_plan_edge_sizes(cuda_device, n):
    """Inputs under 4 elements (the tail alone), under one block's chunk,
    a ragged tail past whole waves, and the train shape; three calls on
    one input are bitwise equal."""
    from distributedpytorch_tpu_torch.ops import loss_kernels as lk

    if n == 0:
        p = t = torch.empty(0, device=cuda_device)
    else:
        p, t = _loss_inputs((n,), cuda_device, seed=n % 5)
    got = [lk.eval_stats(p, t) for _ in range(3)]
    want = lk.eval_stats_reference(p, t)
    torch.cuda.synchronize()
    _assert_stats_match(got[0], want)
    assert torch.equal(got[0], got[1]) and torch.equal(got[0], got[2])


def test_loss_stats_ten_calls_in_a_row_on_different_inputs(cuda_device):
    """Each call leaves the ticket counter at 0 for the next one."""
    from distributedpytorch_tpu_torch.ops import loss_kernels as lk

    cases = [_loss_inputs((4, 160, 240, 1), cuda_device, seed=s)
             for s in range(10)]
    got = [lk.eval_stats(p, t) for p, t in cases]
    torch.cuda.synchronize()
    for out, (p, t) in zip(got, cases):
        _assert_stats_match(out, lk.eval_stats_reference(p, t))


def test_loss_stats_on_two_streams_at_once(cuda_device):
    """Calls enqueued on two streams in turn (each stream has its own
    workspace, so they never share a counter) equal serial calls bit for
    bit."""
    from distributedpytorch_tpu_torch.ops import loss_kernels as lk

    cases = [_loss_inputs((4, 320, 480, 1), cuda_device, seed=s)
             for s in (7, 8)]
    serial = [lk.eval_stats(p, t) for p, t in cases]
    streams = [torch.cuda.Stream(cuda_device) for _ in cases]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream(cuda_device))
    got = [[], []]
    for _ in range(8):
        for i, (s, (p, t)) in enumerate(zip(streams, cases)):
            with torch.cuda.stream(s):
                got[i].append(lk.eval_stats(p, t))
    torch.cuda.synchronize()
    for outs, want in zip(got, serial):
        assert all(torch.equal(out, want) for out in outs)


def test_loss_stats_replays_in_a_cuda_graph(cuda_device):
    """A captured call replays on new data in its static inputs; the
    counter is back at 0 after every replay."""
    from distributedpytorch_tpu_torch.ops import loss_kernels as lk

    cases = [_loss_inputs((2, 64, 96, 1), cuda_device, seed=s)
             for s in range(4)]
    p, t = (x.clone() for x in cases[0])
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(side):
        lk.eval_stats(p, t)  # warm up off the default stream
    torch.cuda.current_stream(cuda_device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = lk.eval_stats(p, t)
    for case in cases[1:] + cases[:1]:
        p.copy_(case[0])
        t.copy_(case[1])
        graph.replay()
        torch.cuda.synchronize()
        want = lk.eval_stats_reference(*case)
        _assert_stats_match(out, want)
        assert torch.equal(out, lk.eval_stats(*case))


def test_loss_stats_entry_point_refuses_a_foreign_plan(cuda_device):
    from distributedpytorch_tpu_torch.ops import loss_kernels as lk

    p, t = _loss_inputs((4, 64, 96, 1), cuda_device)
    n = p.numel()
    plan = lk.loss_stats_plan(n, *lk.card_geometry(p.device))
    before = kernels.LAUNCHES["loss_stats"]
    for foreign in (lk.LossStatsPlan(n, plan.blocks + 1, plan.chunk),
                    lk.LossStatsPlan(n, plan.blocks, plan.chunk + 4),
                    lk.LossStatsPlan(n, 1, 4 * n)):
        with pytest.raises(RuntimeError, match="CUDA error"):
            lk._launch_stats(p, t, foreign)
    assert kernels.LAUNCHES["loss_stats"] == before
    _assert_stats_match(lk._launch_stats(p, t, plan),
                        lk.eval_stats_reference(p, t))


@pytest.mark.parametrize("shape", [(4, 640, 960, 1), (3, 17, 29, 1), (5,)])
def test_loss_stats_backward_kernel_matches_plain_version(cuda_device, shape):
    from distributedpytorch_tpu_torch.ops import loss_kernels as lk

    p, t = _loss_inputs(shape, cuda_device, seed=1)
    ct = torch.randn(4, generator=torch.Generator(device=cuda_device)
                     .manual_seed(2), device=cuda_device)
    before = kernels.LAUNCHES["loss_stats_bwd"]
    got = lk.stats_bwd(p, t, ct)
    want = lk.stats_bwd_reference(p, t, ct)
    bce = lk.stats_bwd(p, t, torch.tensor([1.0, 0.0, 0.0, 0.0],
                                          device=cuda_device))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["loss_stats_bwd"] == before + 2
    assert torch.isfinite(got).all()
    # rounded where the plain version rounds (no fma contraction): rel
    # 1e-6 of the largest gradient is slack
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-6 * float(want.abs().max()))
    tb = t == 1
    saturated = (tb & (p < 1.1754944e-38)) | (~tb & (1.0 - p < 1.1754944e-38))
    assert saturated.any() and not bce[saturated].any()


def test_loss_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    from distributedpytorch_tpu_torch.ops import loss_kernels as lk

    p = torch.rand(4, 8, device=cuda_device)
    t = torch.ones(4, 8, device=cuda_device)
    ct = torch.ones(4, device=cuda_device)
    with pytest.raises(ValueError, match="float32"):
        lk.eval_stats(p.half(), t)
    with pytest.raises(ValueError, match="contiguous"):
        lk.eval_stats(p.t(), t)
    with pytest.raises(ValueError, match="aligned"):
        lk.eval_stats(p.view(-1)[1:], t.view(-1)[1:])
    with pytest.raises(ValueError, match="float32"):
        lk.stats_bwd(p, t.half(), ct)
    with pytest.raises(ValueError, match="contiguous"):
        lk.stats_bwd(p.t(), t, ct)
    with pytest.raises(ValueError, match="4"):
        lk.stats_bwd(p, t, torch.ones(3, device=cuda_device))
    with pytest.raises(ValueError, match="targets"):
        lk.eval_stats(p, t[:2])


def test_fused_loss_on_the_card_launches_both_kernels(cuda_device):
    from distributedpytorch_tpu_torch.ops.fused_loss import (
        fused_bce_dice_loss,
    )
    from distributedpytorch_tpu_torch.ops.losses import bce_dice_loss

    p, t = _loss_inputs((2, 64, 96, 1), cuda_device, seed=3)
    t[t == 255] = 0.0
    # K1 clamps by max(log p, -100) (the Pallas kernel's rule) and the plain
    # loss by losses._clamped_log, which also sends subnormal p to -100:
    # the two agree everywhere else, exact 0 and 1 included
    p[(p > 0) & (p < 1.1754944e-38)] = 0.0
    kernels.reset_launches()
    pk = p.clone().requires_grad_(True)
    loss = fused_bce_dice_loss(pk, t)
    loss.backward()
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["loss_stats"] == 1
    assert kernels.LAUNCHES["loss_stats_bwd"] == 1
    pp = p.clone().requires_grad_(True)
    want = bce_dice_loss(pp, t)
    want.backward()
    torch.testing.assert_close(loss.detach(), want.detach(), rtol=2e-5,
                               atol=0)
    torch.testing.assert_close(pk.grad, pp.grad, rtol=1e-5, atol=1e-7)


def test_train_step_cuda_policy_equals_torch_policy(cuda_device):
    """One float32 step of a small UNet on the card under both kernel
    policies from the same weights and batch: the loss within rel 1e-5
    and the gradients within rel 1e-4 of each tensor's largest."""
    from distributedpytorch_tpu_torch.models.unet import UNet
    from distributedpytorch_tpu_torch.train.steps import make_train_step

    rng = np.random.default_rng(0)
    batch = {
        "image": torch.from_numpy(rng.random((2, 64, 96, 3), np.float32)),
        "mask": torch.from_numpy((rng.random((2, 64, 96)) > 0.6)
                                 .astype(np.int32)),
    }
    batch = {k: v.to(cuda_device) for k, v in batch.items()}
    init = UNet(dtype=torch.float32, widths=(8, 16),
                generator=torch.Generator().manual_seed(0)).state_dict()
    grads, losses = {}, {}
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # float32 convs in float32
    try:
        for fused in (False, True):
            model = UNet(dtype=torch.float32, widths=(8, 16))
            model.load_state_dict(init)
            model.to(cuda_device)
            opt = torch.optim.SGD(model.parameters(), lr=0.0)
            losses[fused] = float(make_train_step(
                model, opt, 2, train_loss_fused=fused)(batch))
            grads[fused] = [p.grad.clone() for p in model.parameters()]
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    np.testing.assert_allclose(losses[True], losses[False], rtol=1e-5)
    for g, h in zip(grads[True], grads[False]):
        torch.testing.assert_close(g, h, rtol=1e-4,
                                   atol=1e-4 * float(h.abs().max()))


# -- -t DDP at world 1 under NCCL ---------------------------------------------


@pytest.fixture
def nccl_world_one(cuda_device, monkeypatch):
    """A one-rank NCCL group on the card, as ``-t DDP`` makes without a
    launcher; destroyed after the test."""
    from distributedpytorch_tpu_torch.dist import runtime

    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    info = runtime.initialize_from_env("cuda")
    assert torch.distributed.get_backend() == "nccl"
    try:
        yield info
    finally:
        runtime.shutdown()


def test_sharded_loss_on_the_card_equals_the_plain_one(nccl_world_one):
    """The DDP loss under kernels cuda: K1 on the shard, the statistics'
    all-reduce, K1-bwd driven by the summed cotangent; at world 1 it is
    the plain loss of the batch, with the tolerances of the fused loss's
    own test above."""
    from distributedpytorch_tpu_torch.ops.fused_loss import make_sharded_loss
    from distributedpytorch_tpu_torch.ops.losses import bce_dice_loss

    p, t = _loss_inputs((2, 64, 96, 1), nccl_world_one.device, seed=4)
    t[t == 255] = 0.0
    p[(p > 0) & (p < 1.1754944e-38)] = 0.0  # see the fused loss's test
    kernels.reset_launches()
    pk = p.clone().requires_grad_(True)
    loss = make_sharded_loss(True)(pk, t)
    loss.backward()
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["loss_stats"] == 1
    assert kernels.LAUNCHES["loss_stats_bwd"] == 1
    pp = p.clone().requires_grad_(True)
    want = bce_dice_loss(pp, t)
    want.backward()
    torch.testing.assert_close(loss.detach(), want.detach(), rtol=2e-5,
                               atol=0)
    torch.testing.assert_close(pk.grad, pp.grad, rtol=1e-5, atol=1e-7)


def test_ddp_step_at_world_one_equals_a_single_gpu_step(nccl_world_one):
    """One float32 step of a small UNet under kernels cuda: through the
    DDP strategy (the wrapped model, the sharded loss, the gradient
    all-reduce) and through ``-t singleGPU``, from the same weights and
    batch. At world 1 every collective is the identity, so the loss and
    the gradients agree within what two cuDNN runs may differ by: rel
    1e-5 and 1e-4 of each tensor's largest."""
    from distributedpytorch_tpu_torch.config import TrainConfig
    from distributedpytorch_tpu_torch.models.unet import UNet
    from distributedpytorch_tpu_torch.parallel.strategy import build_strategy
    from distributedpytorch_tpu_torch.train.steps import make_train_step

    rng = np.random.default_rng(1)
    batch = {
        "image": torch.from_numpy(rng.random((2, 64, 96, 3), np.float32)),
        "mask": torch.from_numpy((rng.random((2, 64, 96)) > 0.6)
                                 .astype(np.int32)),
    }
    batch = {k: v.to(nccl_world_one.device) for k, v in batch.items()}
    init = UNet(dtype=torch.float32, widths=(8, 16),
                generator=torch.Generator().manual_seed(0)).state_dict()
    grads, losses = {}, {}
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for method in ("singleGPU", "DDP"):
            strategy = build_strategy(TrainConfig(train_method=method,
                                                  device="cuda"),
                                      nccl_world_one)
            model = UNet(dtype=torch.float32, widths=(8, 16))
            model.load_state_dict(init)
            model.to(strategy.device)
            opt = torch.optim.SGD(model.parameters(), lr=0.0)
            kernels.reset_launches()
            step = make_train_step(strategy.wrap_model(model), opt, 2,
                                   loss_impl=strategy.train_loss(True))
            losses[method] = float(step(batch))
            assert kernels.LAUNCHES["loss_stats"] == 1
            assert kernels.LAUNCHES["loss_stats_bwd"] == 1
            grads[method] = [p.grad.clone() for p in model.parameters()]
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    np.testing.assert_allclose(losses["DDP"], losses["singleGPU"], rtol=1e-5)
    for g, h in zip(grads["DDP"], grads["singleGPU"]):
        torch.testing.assert_close(g, h, rtol=1e-4,
                                   atol=1e-4 * float(h.abs().max()))


def test_sum_over_ranks_groups_tensors_by_card(nccl_world_one):
    """``sum_over_ranks_`` reduces the tensors of each card in one flat
    all-reduce, cards in the order their first tensor comes (a DDP_MP
    rank's stages); at world 1 the sum and the mean give every tensor
    back as it was, on its own card, whatever the cards' order."""
    from distributedpytorch_tpu_torch.dist.collectives import sum_over_ranks_

    cards = [torch.device("cuda", i)
             for i in range(min(2, torch.cuda.device_count()))]
    order = [cards[-1], cards[0], cards[-1]]
    gen = torch.Generator().manual_seed(0)
    tensors = [torch.randn(5, n + 1, generator=gen).to(dev)
               for n, dev in enumerate(order)]
    want = [t.clone() for t in tensors]
    for mean in (False, True):
        sum_over_ranks_(tensors, mean=mean)
        for got, ref in zip(tensors, want):
            assert got.device == ref.device and torch.equal(got, ref)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_pipeline_data_seams_at_world_one_equal_the_mp_step(nccl_world_one,
                                                           schedule):
    """A float32 milesial pipeline step (2 stages on the card, 2
    microbatches, kernels cuda) with the DDP_MP seams and without them, at
    world 1 under NCCL, from the same weights and batch: the statistics'
    and the gradients' all-reduces are copies, so loss and gradients are
    bitwise equal; the running averages, set to ``before + (after −
    before)``, within 1e-6 of their largest."""
    from distributedpytorch_tpu_torch.config import TrainConfig
    from distributedpytorch_tpu_torch.models import create_model
    from distributedpytorch_tpu_torch.parallel.pipeline import (
        build_stages,
        make_pipeline_train_step,
    )

    dev = nccl_world_one.device
    cfg = TrainConfig(model_arch="milesial", model_widths=(8, 16),
                      dtype="f32", device="cuda")
    init = create_model(cfg, generator=torch.Generator().manual_seed(0)
                        ).state_dict()
    rng = np.random.default_rng(1)
    batch = {
        "image": torch.from_numpy(rng.random((4, 32, 48, 3), np.float32)),
        "mask": torch.from_numpy((rng.random((4, 32, 48)) > 0.6)
                                 .astype(np.int32)),
    }
    batch = {k: v.to(dev) for k, v in batch.items()}
    runs = {}
    for data_parallel in (False, True):
        model = create_model(cfg)
        model.load_state_dict(init)
        model.to(dev)
        stages = build_stages(model, [dev, dev])
        opt = torch.optim.SGD(model.parameters(), lr=0.0)
        step = make_pipeline_train_step(model, stages, opt, 4, 2, schedule,
                                        train_loss_fused=True,
                                        data_parallel=data_parallel)
        runs[data_parallel] = (
            step(batch), [p.grad.clone() for p in model.parameters()],
            {n: b.clone() for n, b in model.named_buffers()
             if "running" in n})
    (loss, grads, stats), (dp_loss, dp_grads, dp_stats) = runs[False], \
        runs[True]
    assert torch.equal(dp_loss, loss)
    for g, h in zip(dp_grads, grads):
        assert torch.equal(g, h)
    for name, t in stats.items():
        torch.testing.assert_close(dp_stats[name], t, rtol=0,
                                   atol=1e-6 * float(t.abs().max()))


# -- milesial's BatchNorm epilogue (K2, K3) and the 9-tap wgrad (K5) ---------


def _bn_case(shape, device, seed=0):
    """NCHW bf16 x in channels_last memory with z = x·a + b exactly 0 at
    some pixels (a = b = 0 on channel 0; b = 0 and x = 0 on channel 1)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    b, c, h, w = shape
    x = torch.randn((b, h, w, c), generator=gen, device=device).to(
        torch.bfloat16).permute(0, 3, 1, 2)
    x[:, 1].reshape(-1)[::3] = 0.0
    a = torch.rand(c, generator=gen, device=device) + 0.5
    bias = 0.1 * torch.randn(c, generator=gen, device=device)
    mean = 0.1 * torch.randn(c, generator=gen, device=device)
    a[0] = bias[0] = bias[1] = 0.0
    g = torch.randn(shape, generator=gen, device=device).contiguous(
        memory_format=torch.channels_last)
    return x, a, bias, mean, g


@pytest.mark.parametrize("shape", [(4, 64, 640, 960), (3, 1024, 17, 29),
                                   (2, 6, 5, 7)])
def test_bn_act_kernels_match_plain_versions(cuda_device, shape):
    """K2's y and K3's dx equal the plain versions bit for bit (rounded at
    the same places); K3's channel sums within 1e-5 of each row's largest
    (float32 sums in other orders) and two calls bitwise equal. 6
    channels take the kernels' scalar path."""
    x, a, b, mean, g = _bn_case(shape, cuda_device)
    before = dict(kernels.LAUNCHES)
    y = kernels.bn_act(x, a, b)
    dx, sums = kernels.bn_act_bwd(x, g, a, b, mean)
    dx2, sums2 = kernels.bn_act_bwd(x, g, a, b, mean)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["bn_act"] == before["bn_act"] + 1
    assert kernels.LAUNCHES["bn_act_bwd"] == before["bn_act_bwd"] + 2
    assert torch.equal(y, kernels.bn_act_reference(x, a, b))
    dx_want, sums_want = kernels.bn_act_bwd_reference(x, g, a, b, mean)
    assert dx.dtype == torch.bfloat16 and torch.equal(dx, dx_want)
    scale = sums_want.abs().amax(dim=1, keepdim=True)
    assert float(((sums - sums_want).abs() / scale).max()) <= 1e-5
    assert torch.equal(dx, dx2) and torch.equal(sums, sums2)


def test_bn_act_takes_other_layouts_by_an_explicit_copy(cuda_device):
    x, a, b, _mean, _g = _bn_case((2, 16, 5, 7), cuda_device)
    nchw = x.contiguous()  # a plain NCHW layout
    assert not nchw.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(kernels.bn_act(nchw, a, b), kernels.bn_act(x, a, b))
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        kernels.bn_act(x.half(), a, b)


@pytest.mark.parametrize("b,h,w,cin,cout,dtype", [
    (4, 40, 60, 128, 128, torch.bfloat16),
    (2, 9, 37, 144, 128, torch.bfloat16),   # ragged plane and a partial tile
    (1, 6, 35, 24, 40, torch.float32),
    (2, 7, 70, 128, 256, torch.bfloat16),   # W not a multiple of 64 pixels
    (3, 1, 64, 128, 128, torch.bfloat16),   # H = 1: both kernel-row pads
    (2, 5, 20, 128, 128, torch.bfloat16),   # narrower than one segment
    (2, 8, 16, 1024, 128, torch.bfloat16),  # asymmetric, many ci tiles
    (1, 6, 33, 128, 144, torch.bfloat16),   # a partial co tile
    (1, 6, 35, 16, 32, torch.bfloat16),     # channels under one TMA box
])
def test_wgrad_kernel_matches_plain_version_and_cudnn(cuda_device, b, h, w,
                                                      cin, cout, dtype):
    """K5 within 1e-4 of the plain version's largest (float32 sums of
    exact products in other orders), within 1e-2 of cuDNN's (which rounds
    its result to the input dtype), and bitwise repeatable. The bf16
    cases cover the edges of its tiles: the pixel segment, the padding
    rows and columns that the TMA fills with zeros, and partial channel
    tiles."""
    from distributedpytorch_tpu_torch.ops import wgrad_kernels as wk

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn((b, h, w, cin), generator=gen, device=cuda_device).to(
        dtype)
    dy = torch.randn((b, h, w, cout), generator=gen, device=cuda_device).to(
        dtype)
    before = kernels.LAUNCHES["wgrad_9tap"]
    got = wk.wgrad_9tap(x, dy)
    again = wk.wgrad_9tap(x, dy)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["wgrad_9tap"] == before + 2
    assert torch.equal(got, again)
    want = wk.wgrad_9tap_reference(x, dy)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-4 * scale
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        lib = torch.nn.grad.conv2d_weight(
            x.permute(0, 3, 1, 2), (cout, cin, 3, 3), dy.permute(0, 3, 1, 2),
            padding=1).float().permute(2, 3, 1, 0)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert float((got - lib).abs().max()) <= 1e-2 * scale


def test_wgrad_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    from distributedpytorch_tpu_torch.ops import wgrad_kernels as wk

    x = torch.zeros((1, 4, 8, 128), dtype=torch.bfloat16, device=cuda_device)
    dy = torch.zeros((1, 4, 8, 128), dtype=torch.bfloat16, device=cuda_device)
    before = kernels.LAUNCHES["wgrad_9tap"]
    with pytest.raises(ValueError, match="multiples of 16"):
        wk.wgrad_9tap(x[..., :120].contiguous(), dy)
    flat = torch.zeros(x.numel() + 1, dtype=torch.bfloat16,
                       device=cuda_device)
    with pytest.raises(ValueError, match="aligned"):
        wk.wgrad_9tap(flat[1:].view(x.shape), dy)
    with pytest.raises(ValueError, match="contiguous"):
        wk.wgrad_9tap(x.transpose(1, 2), dy.transpose(1, 2))
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        wk.wgrad_9tap(x.half(), dy.half())
    assert kernels.LAUNCHES["wgrad_9tap"] == before


def _milesial_step(cuda_device, policy, batch, init, base):
    from distributedpytorch_tpu_torch.config import TrainConfig
    from distributedpytorch_tpu_torch.models import create_model
    from distributedpytorch_tpu_torch.train.steps import make_train_step

    model = create_model(TrainConfig(kernels=policy, **base))
    model.load_state_dict(init)
    model.to(cuda_device)
    opt = torch.optim.SGD(model.parameters(), lr=0.0)
    kernels.reset_launches()
    loss = float(make_train_step(model, opt, 2,
                                 train_loss_fused=policy == "cuda")(batch))
    return (loss, dict(kernels.LAUNCHES),
            [p.grad.clone() for p in model.parameters()],
            [b.clone() for n, b in model.named_buffers() if "running" in n])


@pytest.fixture
def milesial_case(cuda_device, monkeypatch):
    """A small float32 milesial with --wgrad-taps (widths 16-128-128, so
    five of its convs reach K5), its initial weights and one batch, with
    DPT_WGRAD_BACKEND=pallas and float32 convs in float32."""
    from distributedpytorch_tpu_torch.config import TrainConfig
    from distributedpytorch_tpu_torch.models import create_model

    monkeypatch.setenv("DPT_WGRAD_BACKEND", "pallas")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    rng = np.random.default_rng(0)
    batch = {
        "image": torch.from_numpy(rng.random((2, 32, 48, 3), np.float32)),
        "mask": torch.from_numpy((rng.random((2, 32, 48)) > 0.6)
                                 .astype(np.int32)),
    }
    batch = {k: v.to(cuda_device) for k, v in batch.items()}
    base = dict(model_arch="milesial", model_widths=(16, 128, 128),
                wgrad_taps=True, dtype="f32", device="cuda")
    init = create_model(TrainConfig(**base), generator=torch.Generator()
                        .manual_seed(0)).state_dict()
    return batch, init, base


def _rel_l2(got, want):
    return max(float((g - h).norm() / h.norm()) for g, h in zip(got, want))


def test_milesial_step_cuda_policy_equals_torch_policy(cuda_device,
                                                       milesial_case):
    """One float32 step under both kernel policies (K2, K3 and, for five
    convs, K5, against plain BatchNorm and the einsums): the loss within
    rel 1e-5, each gradient within 2e-2 relative L2 and the running
    statistics within 1e-5 of their largest. The policies normalize with
    other associations, so a pixel with z within rounding of 0 may take
    the other side of a ReLU, and a BatchNorm backward spreads that over
    its channel: the gradient bound is that of the full-width comparison
    in chip_smoke.py."""
    batch, init, base = milesial_case
    loss_c, launches, grads_c, stats_c = _milesial_step(
        cuda_device, "cuda", batch, init, base)
    loss_t, _, grads_t, stats_t = _milesial_step(
        cuda_device, "torch", batch, init, base)
    # 10 BatchNorms; K5 takes down1's 128->128, down2's two and up1's
    # 192->128 and 128->128
    assert launches["bn_act"] == 10 and launches["bn_act_bwd"] == 10
    assert launches["wgrad_9tap"] == 5
    np.testing.assert_allclose(loss_c, loss_t, rtol=1e-5)
    assert _rel_l2(grads_c, grads_t) <= 2e-2
    for s, t in zip(stats_c, stats_t):
        torch.testing.assert_close(s, t, rtol=0,
                                   atol=1e-5 * float(t.abs().max()))


def test_milesial_kernels_equal_their_plain_versions_in_place(
        cuda_device, milesial_case, monkeypatch):
    """The same kernels-cuda step twice, the second with every kernel's
    wrapper swapped for its plain version: K2 equals its plain version bit
    for bit, so the forward, the loss's inputs and the running statistics
    are identical; only K1's, K3's and K5's sums run in other orders, so
    the loss agrees within rel 1e-6 and each gradient within 1e-4
    relative L2."""
    from distributedpytorch_tpu_torch.ops import conv_backward, fused_loss
    from distributedpytorch_tpu_torch.ops import loss_kernels as lk
    from distributedpytorch_tpu_torch.ops import wgrad_kernels as wk

    batch, init, base = milesial_case
    loss_k, launches, grads_k, stats_k = _milesial_step(
        cuda_device, "cuda", batch, init, base)
    assert launches["bn_act"] == 10 and launches["wgrad_9tap"] == 5
    monkeypatch.setattr(kernels, "bn_act", kernels.bn_act_reference)
    monkeypatch.setattr(kernels, "bn_act_bwd", kernels.bn_act_bwd_reference)
    monkeypatch.setattr(conv_backward, "wgrad_9tap",
                        wk.wgrad_9tap_reference)
    monkeypatch.setattr(fused_loss, "bce_dice_stats_kernel",
                        lambda p, t: lk.eval_stats_reference(p, t)[:4])
    monkeypatch.setattr(fused_loss, "stats_bwd", lk.stats_bwd_reference)
    loss_p, launches, grads_p, stats_p = _milesial_step(
        cuda_device, "cuda", batch, init, base)
    assert not any(launches.values())
    np.testing.assert_allclose(loss_k, loss_p, rtol=1e-6)
    for s, t in zip(stats_k, stats_p):
        assert torch.equal(s, t)
    assert _rel_l2(grads_k, grads_p) <= 1e-4


# -- run control: the CUDA graph of K steps, remat ------------------------------


def _unet_trainer_parts(cuda_device, capturable=True):
    """A small float32 UNet on the card under kernels cuda, its capturable
    Adam and its train step."""
    from distributedpytorch_tpu_torch.models.unet import UNet
    from distributedpytorch_tpu_torch.ops.optim import make_optimizer
    from distributedpytorch_tpu_torch.train.steps import make_train_step

    model = UNet(dtype=torch.float32, widths=(8, 16),
                 generator=torch.Generator().manual_seed(0)).to(cuda_device)
    opt = make_optimizer(model.parameters(), 1e-3, capturable=capturable)
    return model, opt, make_train_step(model, opt, 2, train_loss_fused=True)


def _stacks(cuda_device, n, k=3):
    rng = np.random.default_rng(0)
    return [{"image": torch.from_numpy(rng.random((k, 2, 32, 48, 3),
                                                  np.float32)).to(cuda_device),
             "mask": torch.from_numpy((rng.random((k, 2, 32, 48)) > 0.6)
                                      .astype(np.int32)).to(cuda_device)}
            for _ in range(n)]


def test_k_step_graph_equals_eager_steps_bitwise(cuda_device, monkeypatch):
    """Three calls of the K = 3 multi-step (eager warm-up, capture and
    replay, replay) against nine eager steps of the same capturable Adam
    from the same weights: the nine losses and the weights bitwise equal.
    cuDNN keeps to its deterministic algorithms here: at this size one of
    its default ones adds in a run-dependent order, and two eager runs
    already differ in the last bit. A replay runs three K1 and three
    K1-bwd kernels, counted by name in the profiler's trace; the wrappers
    count the warm-up's launches and the capture's, none at a replay."""
    from torch.profiler import ProfilerActivity, profile

    from distributedpytorch_tpu_torch.train.steps import make_multi_train_step

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    stacks = _stacks(cuda_device, 3)
    model_e, _opt, step = _unet_trainer_parts(cuda_device)
    eager = [float(step({k: v[i] for k, v in s.items()}))
             for s in stacks for i in range(3)]
    model_g, _opt, step = _unet_trainer_parts(cuda_device)
    multi = make_multi_train_step(step, 3, cuda_device)
    kernels.reset_launches()
    graphed = []
    for s in stacks:
        graphed += [float(x) for x in multi(s)]
    assert graphed == eager
    for a, b in zip(model_e.parameters(), model_g.parameters()):
        assert torch.equal(a, b)
    # warm-up 3 + capture 3, each kernel
    assert kernels.LAUNCHES["loss_stats"] == 6
    assert kernels.LAUNCHES["loss_stats_bwd"] == 6
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        multi(stacks[0])
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum(bool(re.search(r"\bstats_kernel\b", n)) for n in names) == 3
    assert sum(bool(re.search(r"\bstats_bwd_kernel\b", n))
               for n in names) == 3
    assert kernels.LAUNCHES["loss_stats"] == 6


def test_set_learning_rate_between_replays_changes_the_graphs_lr(
        cuda_device):
    """The lr is a tensor the graph reads at each replay: set to 0 the
    replay leaves the weights (Adam's update and its L2 term both scale by
    it), set back it moves them."""
    from distributedpytorch_tpu_torch.ops.optim import (
        get_learning_rate,
        set_learning_rate,
    )
    from distributedpytorch_tpu_torch.train.steps import make_multi_train_step

    stacks = _stacks(cuda_device, 4)
    model, opt, step = _unet_trainer_parts(cuda_device)
    multi = make_multi_train_step(step, 3, cuda_device)
    multi(stacks[0])
    multi(stacks[1])  # captured
    lr_tensor = opt.param_groups[0]["lr"]
    set_learning_rate(opt, 0.0)
    assert opt.param_groups[0]["lr"] is lr_tensor
    assert get_learning_rate(opt) == 0.0
    before = [p.detach().clone() for p in model.parameters()]
    multi(stacks[2])
    assert all(torch.equal(a, p) for a, p in zip(before, model.parameters()))
    set_learning_rate(opt, 1e-3)
    multi(stacks[3])
    assert not all(torch.equal(a, p)
                   for a, p in zip(before, model.parameters()))


@pytest.mark.parametrize("first,then", [(1, 4), (4, 1)])
def test_resume_across_steps_per_dispatch_trains_on(cuda_device, tmp_path,
                                                    first, then):
    """A checkpoint written at ``--steps-per-dispatch first`` resumed at
    ``then`` trains its next epoch on the card. torch's
    ``load_state_dict`` takes each param group whole from the
    checkpoint; the trainer keeps this run's ``capturable`` (K > 1 on the
    card), with the lr and Adam's step counts on the card then and a
    float lr and step counts on the CPU otherwise, so the K = 4 capture
    and the K = 1 steps both run and their losses are finite."""
    from distributedpytorch_tpu_torch.config import TrainConfig
    from distributedpytorch_tpu_torch.train.loop import Trainer

    def config(k, epochs, **kw):
        return TrainConfig(
            epochs=epochs, batch_size=2, val_percent=25.0, seed=0,
            image_size=(48, 32), model_widths=(8, 16), synthetic_samples=16,
            metric_every_steps=1, num_workers=0, s2d_levels=0, dtype="f32",
            kernels="cuda", device=str(cuda_device), steps_per_dispatch=k,
            checkpoint_dir=str(tmp_path / "checkpoints"),
            log_dir=str(tmp_path / "logs"), loss_dir=str(tmp_path / "loss"),
            **kw)

    Trainer(config(first, 1)).train()
    again = Trainer(config(then, 2, checkpoint_name="singleGPU"))
    graphed = then > 1
    for group in again.optimizer.param_groups:
        assert group["capturable"] is graphed
        assert isinstance(group["lr"], torch.Tensor) is graphed
    assert again.optimizer.state
    for state in again.optimizer.state.values():
        assert state["step"].device.type == ("cuda" if graphed else "cpu")
    result = again.train()
    # 12 train samples at -b 2: 6 steps an epoch
    assert again.start_epoch == 1 and result["steps"] == 12
    assert np.isfinite([float(x) for x in again.records.losses]).all()


def test_milesial_remat_step_equals_the_plain_step(cuda_device,
                                                   milesial_case):
    """The kernels-cuda milesial step with ``remat`` against the one
    without: K2 launches twice (forward and recompute), K3 and K5 once;
    the loss and the running statistics (moved once) bitwise equal, and
    each gradient within 1e-6 of its tensor's largest (a recompute runs
    the same kernels on the same inputs; only the order autograd adds
    the BatchNorm statistics' gradients may differ)."""
    from distributedpytorch_tpu_torch.config import TrainConfig
    from distributedpytorch_tpu_torch.models import create_model
    from distributedpytorch_tpu_torch.train.steps import make_train_step

    batch, init, base = milesial_case
    out = {}
    for remat in (False, True):
        model = create_model(TrainConfig(kernels="cuda", **base))
        model.load_state_dict(init)
        model.to(cuda_device)
        opt = torch.optim.SGD(model.parameters(), lr=0.0)
        kernels.reset_launches()
        loss = float(make_train_step(model, opt, 2, train_loss_fused=True,
                                     remat=remat)(batch))
        out[remat] = (loss, dict(kernels.LAUNCHES),
                      [p.grad.clone() for p in model.parameters()],
                      [b.clone() for n, b in model.named_buffers()
                       if "running" in n])
    (l0, n0, g0, s0), (l1, n1, g1, s1) = out[False], out[True]
    assert n1["bn_act"] == 2 * n0["bn_act"] == 20
    assert n1["bn_act_bwd"] == n0["bn_act_bwd"] == 10
    assert n1["wgrad_9tap"] == n0["wgrad_9tap"] == 5
    assert l1 == l0
    for a, b in zip(s1, s0):
        assert torch.equal(a, b)
    for a, b in zip(g1, g0):
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())


# -- the K-step graph under MP ---------------------------------------------------


def _mp_parts(devices, schedule, dtype="f32"):
    """A small UNet through the MP strategy's pipeline (M = 2) on
    ``devices``, under kernels cuda, with capturable Adam."""
    from distributedpytorch_tpu_torch.config import TrainConfig
    from distributedpytorch_tpu_torch.models import create_model
    from distributedpytorch_tpu_torch.ops.kernels import get_kernel_policy
    from distributedpytorch_tpu_torch.ops.optim import make_optimizer
    from distributedpytorch_tpu_torch.parallel.strategy import build_strategy

    cfg = TrainConfig(train_method="MP", num_stages=len(devices),
                      num_microbatches=2, pipeline_schedule=schedule,
                      dtype=dtype, kernels="cuda", device="cuda",
                      model_widths=(8, 16), batch_size=2,
                      steps_per_dispatch=3)
    strategy = build_strategy(cfg, devices=devices)
    model = create_model(cfg, generator=torch.Generator().manual_seed(0))
    model = strategy.place_model(model)
    opt = make_optimizer(model.parameters(), 1e-3, capturable=True)
    step = strategy.build_train_step(model, opt, get_kernel_policy("cuda"))
    return model, opt, step, strategy


def _graph_against_eager(devices, parts, k=3):
    """Three calls of the K = ``k`` multi-step of ``parts()``'s step
    (``(model, opt, step, strategy)``: ``_mp_parts``, ``_dp_parts``,
    ``_sp_parts``) over ``devices`` against 3·k eager steps from the same
    weights, after each call every card's cache emptied and a guard
    tensor allocated on it that the next replay must leave alone: (eager
    losses, graph losses, weights and buffers equal, guards intact)."""
    from distributedpytorch_tpu_torch.train.steps import make_multi_train_step

    stacks = _stacks(devices[0], 3, k)
    model_e, _opt, step, _s = parts()
    eager = [float(step({key: v[i] for key, v in s.items()}))
             for s in stacks for i in range(k)]
    model_g, _opt, step, strategy = parts()
    multi = make_multi_train_step(step, k, strategy.step_devices)
    graphed, intact, guards = [], True, []
    for s in stacks:
        graphed += [float(x) for x in multi(s)]
        for d in dict.fromkeys(devices):
            torch.cuda.synchronize(d)
        intact = intact and all(bool((g == 7.0).all()) for g in guards)
        torch.cuda.empty_cache()
        guards = [torch.full((1 << 22,), 7.0, device=d)
                  for d in dict.fromkeys(devices)]
    same = all(torch.equal(a, b) for a, b in zip(
        model_e.state_dict().values(), model_g.state_dict().values()))
    return eager, graphed, same, intact


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_mp_k_step_graph_on_one_card_equals_eager_bitwise(
        cuda_device, monkeypatch, schedule):
    """``-t MP`` with both stages on cuda:0, K = 3: the graph's nine losses
    and the weights bitwise equal to nine eager steps of the same
    capturable Adam (cuDNN's deterministic algorithms), and guard tensors
    allocated between replays left alone."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    devices = [cuda_device, cuda_device]
    eager, graphed, same, intact = _graph_against_eager(
        devices, lambda: _mp_parts(devices, schedule))
    assert graphed == eager and same and intact


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_mp_k_step_graph_across_two_cards_equals_eager_bitwise(
        monkeypatch, schedule):
    """The same across cuda:0 and cuda:1: the capture joins the second
    card's stream to the capturing one, its allocations go to a pool of
    the graph's own, and eager work between replays (the emptied cache,
    the guards) takes none of its memory."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA cards")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    devices = [torch.device("cuda", 0), torch.device("cuda", 1)]
    eager, graphed, same, intact = _graph_against_eager(
        devices, lambda: _mp_parts(devices, schedule))
    assert graphed == eager and same and intact


# -- -t DP: the K-step graph and --remat ---------------------------------------------


def _dp_parts(devices, arch="unet", remat=False):
    """A small float32 model through the DP strategy's replicas on
    ``devices`` (batch 2: one sample per replica on two), under kernels
    cuda, with capturable Adam."""
    from distributedpytorch_tpu_torch.config import TrainConfig
    from distributedpytorch_tpu_torch.models import create_model
    from distributedpytorch_tpu_torch.ops.kernels import get_kernel_policy
    from distributedpytorch_tpu_torch.ops.optim import make_optimizer
    from distributedpytorch_tpu_torch.parallel.strategy import build_strategy

    cfg = TrainConfig(train_method="DP", model_arch=arch, dtype="f32",
                      kernels="cuda", device="cuda", model_widths=(8, 16),
                      batch_size=2, steps_per_dispatch=3, remat=remat)
    strategy = build_strategy(cfg, devices=devices)
    assert strategy.devices == list(devices)
    model = create_model(cfg, generator=torch.Generator().manual_seed(0))
    model = strategy.place_model(model)
    opt = make_optimizer(model.parameters(), 1e-3, capturable=True)
    step = strategy.build_train_step(model, opt, get_kernel_policy("cuda"))
    return model, opt, step, strategy


@pytest.mark.parametrize("arch", ["unet", "milesial"])
def test_dp_k_step_graph_on_one_card_equals_eager_bitwise(
        cuda_device, monkeypatch, arch):
    """``-t DP`` on ``[cuda:0, cuda:0]`` (two replica threads on one card,
    meeting at milesial's BatchNorms), K = 3: the graph's nine losses,
    the weights and the running statistics bitwise equal to nine eager
    steps of the same capturable Adam (cuDNN's deterministic
    algorithms), and guard tensors allocated between replays left alone:
    the replica thread's allocations went to the graph's pool."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    devices = [cuda_device, cuda_device]
    eager, graphed, same, intact = _graph_against_eager(
        devices, lambda: _dp_parts(devices, arch))
    assert graphed == eager and same and intact


@pytest.mark.parametrize("arch", ["unet", "milesial"])
def test_dp_k_step_graph_across_two_cards_equals_eager_bitwise(
        monkeypatch, arch):
    """The same with the replicas on cuda:0 and cuda:1: the parameters,
    the BatchNorm moments and the predictions cross cards through copies
    whose backward the capture holds, and the second card's allocations
    go to a pool of the graph's own."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA cards")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    devices = [torch.device("cuda", 0), torch.device("cuda", 1)]
    eager, graphed, same, intact = _graph_against_eager(
        devices, lambda: _dp_parts(devices, arch))
    assert graphed == eager and same and intact


def test_dp_replica_threads_launch_on_the_callers_stream(cuda_device):
    """A DP step with a side stream current in the caller: every
    BatchNorm forward, replica 0's in the caller and replica 1's in its
    own thread, runs with that stream current, and the step's loss
    equals the same step's on the default stream."""
    model, _opt, step, _s = _dp_parts([cuda_device, cuda_device],
                                      "milesial")
    from distributedpytorch_tpu_torch.models.milesial import BatchNormAct

    seen = []

    def hook(_bn, _args):
        seen.append((threading.current_thread().name,
                     torch.cuda.current_stream(cuda_device)))

    for m in model.modules():
        if isinstance(m, BatchNormAct):
            m.register_forward_pre_hook(hook)
    batch = {k: v[0] for k, v in _stacks(cuda_device, 1)[0].items()}
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(side):
        float(step(batch))
    torch.cuda.current_stream(cuda_device).wait_stream(side)
    threads = {name for name, _ in seen}
    assert "dpt-dp-replica-1" in threads and len(threads) == 2
    assert all(stream == side for _, stream in seen)


def test_dp_remat_step_equals_the_plain_step_on_one_card(cuda_device,
                                                          monkeypatch):
    """milesial under ``-t DP --remat`` on ``[cuda:0, cuda:0]`` against
    the plain DP step, cuDNN deterministic: it completes (autograd
    recomputes both replicas on the card's one thread, which a second
    meeting would hang), K2 launches twice per BatchNorm and replica,
    K3 once, and the loss, every gradient and the running statistics
    are bitwise equal."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    batch = {k: v[0] for k, v in _stacks(cuda_device, 1)[0].items()}
    out = {}
    for remat in (False, True):
        model, opt, step, _s = _dp_parts([cuda_device, cuda_device],
                                         "milesial", remat=remat)
        opt.step = lambda: None  # keep the gradients and the weights
        kernels.reset_launches()
        loss = float(step(batch))
        torch.cuda.synchronize()
        out[remat] = (loss, dict(kernels.LAUNCHES),
                      [p.grad.clone() for p in model.parameters()],
                      [b.clone() for n, b in model.named_buffers()
                       if "running" in n])
    (l0, n0, g0, s0), (l1, n1, g1, s1) = out[False], out[True]
    # 6 BatchNorms at widths (8, 16), in each of the two replicas
    assert n1["bn_act"] == 2 * n0["bn_act"] == 24
    assert n1["bn_act_bwd"] == n0["bn_act_bwd"] == 12
    assert l1 == l0
    for a, b in zip(g1 + s1, g0 + s0):
        assert torch.equal(a, b)


# -- -t SP: the K-step graph and --remat ---------------------------------------------


def _sp_parts(devices, arch="unet", remat=False):
    """A small float32 model through the SP strategy's row shards on
    ``devices`` (batch 2 of 32 × 48 images, 16 rows a shard on two),
    under kernels cuda, with capturable Adam."""
    from distributedpytorch_tpu_torch.config import TrainConfig
    from distributedpytorch_tpu_torch.models import create_model
    from distributedpytorch_tpu_torch.ops.kernels import get_kernel_policy
    from distributedpytorch_tpu_torch.ops.optim import make_optimizer
    from distributedpytorch_tpu_torch.parallel.strategy import build_strategy

    cfg = TrainConfig(train_method="SP", model_arch=arch, dtype="f32",
                      kernels="cuda", device="cuda", model_widths=(8, 16),
                      image_size=(48, 32), batch_size=2,
                      steps_per_dispatch=2, remat=remat)
    strategy = build_strategy(cfg, devices=devices)
    assert strategy.devices == list(devices)
    model = create_model(cfg, generator=torch.Generator().manual_seed(0))
    model = strategy.place_model(model)
    opt = make_optimizer(model.parameters(), 1e-3, capturable=True)
    step = strategy.build_train_step(model, opt, get_kernel_policy("cuda"))
    return model, opt, step, strategy


@pytest.mark.parametrize("arch", ["unet", "milesial"])
def test_sp_k_step_graph_on_one_card_equals_eager_bitwise(
        cuda_device, monkeypatch, arch):
    """``-t SP`` on ``[cuda:0, cuda:0]`` (two row-shard threads on one card,
    meeting at every 3×3 conv for their halo rows and at milesial's
    BatchNorms), K = 2: the graph's six losses, the weights and the
    running statistics bitwise equal to six eager steps of the same
    capturable Adam (cuDNN's deterministic algorithms), and guard
    tensors allocated between replays left alone."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    devices = [cuda_device, cuda_device]
    eager, graphed, same, intact = _graph_against_eager(
        devices, lambda: _sp_parts(devices, arch), k=2)
    assert graphed == eager and same and intact


@pytest.mark.parametrize("arch", ["unet", "milesial"])
def test_sp_k_step_graph_across_two_cards_equals_eager_bitwise(
        monkeypatch, arch):
    """The same with the shards on cuda:0 and cuda:1: each halo row crosses
    cards in the forward and its gradient back in the backward, inside
    the capture, and the second card's allocations go to a pool of the
    graph's own."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA cards")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    devices = [torch.device("cuda", 0), torch.device("cuda", 1)]
    eager, graphed, same, intact = _graph_against_eager(
        devices, lambda: _sp_parts(devices, arch), k=2)
    assert graphed == eager and same and intact


def test_sp_remat_step_equals_the_plain_step_on_one_card(cuda_device,
                                                          monkeypatch):
    """The UNet under ``-t SP --remat`` on ``[cuda:0, cuda:0]`` against the
    plain SP step, cuDNN deterministic: it completes (autograd recomputes
    both shards on the card's one thread, where a meeting would hang),
    K1 and K1-bwd launch once per shard, and the loss and every gradient
    are bitwise equal."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    batch = {k: v[0] for k, v in _stacks(cuda_device, 1)[0].items()}
    out = {}
    for remat in (False, True):
        model, opt, step, _s = _sp_parts([cuda_device, cuda_device],
                                         remat=remat)
        opt.step = lambda: None  # keep the gradients and the weights
        kernels.reset_launches()
        loss = float(step(batch))
        torch.cuda.synchronize()
        out[remat] = (loss, dict(kernels.LAUNCHES),
                      [p.grad.clone() for p in model.parameters()])
    (l0, n0, g0), (l1, n1, g1) = out[False], out[True]
    assert n1["loss_stats"] == n0["loss_stats"] == 2
    assert n1["loss_stats_bwd"] == n0["loss_stats_bwd"] == 2
    assert l1 == l0
    for a, b in zip(g1, g0):
        assert torch.equal(a, b)


def test_capturable_adam_over_two_groups_reads_each_lr_at_replay(
        cuda_device):
    """Capturable Adam over two param groups on one card, each with its
    own lr tensor (the groups ``make_optimizer`` gives a pipeline's two
    cards, made by hand on the one), captured in a graph of a step:
    ``set_learning_rate`` between replays writes into both tensors, so a
    replay at 0 leaves every parameter, and back at 1e-3 moves both
    groups."""
    from distributedpytorch_tpu_torch.ops.optim import set_learning_rate

    a = torch.nn.Parameter(torch.linspace(-1, 1, 64, device=cuda_device))
    b = torch.nn.Parameter(torch.linspace(1, 2, 32, device=cuda_device))
    opt = torch.optim.Adam(
        [{"params": [a], "lr": torch.tensor(1e-3, device=cuda_device)},
         {"params": [b], "lr": torch.tensor(1e-3, device=cuda_device)}],
        lr=1e-3, capturable=True)
    lrs = [g["lr"] for g in opt.param_groups]

    def step():
        opt.zero_grad(set_to_none=True)
        ((a * a).sum() + (b * b * b).sum()).backward()
        opt.step()

    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream(cuda_device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    set_learning_rate(opt, 0.0)
    assert [g["lr"] for g in opt.param_groups] == lrs  # the same tensors
    before = [a.detach().clone(), b.detach().clone()]
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(a, before[0]) and torch.equal(b, before[1])
    set_learning_rate(opt, 1e-3)
    graph.replay()
    torch.cuda.synchronize()
    assert not torch.equal(a, before[0]) and not torch.equal(b, before[1])


def _small_config(cuda_device, tmp_path, **kw):
    from distributedpytorch_tpu_torch.config import TrainConfig

    return TrainConfig(**{
        **dict(epochs=1, batch_size=2, val_percent=25.0, seed=0,
               image_size=(48, 32), model_widths=(8, 16),
               synthetic_samples=16, metric_every_steps=1, num_workers=0,
               s2d_levels=0, dtype="f32", kernels="cuda",
               device=str(cuda_device),
               checkpoint_dir=str(tmp_path / "checkpoints"),
               log_dir=str(tmp_path / "logs"),
               loss_dir=str(tmp_path / "loss")), **kw})


def test_every_probe_accepts_its_kernel_on_the_card(cuda_device, tmp_path):
    """``run_probes`` on the card: each kernel built, launched in a child
    process and held against its plain version; the file reads back and
    a rejection in it disengages its field before a trainer's run."""
    from distributedpytorch_tpu_torch.ops import probes

    payload = probes.run_probes(device=cuda_device)
    assert payload["platform"] == "gpu"
    for name, row in payload["kernels"].items():
        assert row["accepted"], (name, row)
        assert row["launch_s"] > 0
    path = str(tmp_path / "priors.json")
    payload["kernels"]["fused_loss"] = {"accepted": False, "reason": "test",
                                        "compile_s": 0.0}
    kernels.save_priors(payload, path)
    from distributedpytorch_tpu_torch.train.loop import Trainer

    trainer = Trainer(_small_config(cuda_device, tmp_path,
                                    kernel_priors=path))
    assert not trainer.kernels.train_loss_fused
    assert trainer.kernels.eval_stats_fused
    kernels.reset_launches()
    trainer.train()
    # 6 steps through the plain loss, the 2 eval batches through K1
    assert kernels.LAUNCHES["loss_stats_bwd"] == 0
    assert kernels.LAUNCHES["loss_stats"] == 2


@pytest.mark.parametrize("k", [1, 2])
def test_the_profiler_window_traces_the_loss_kernels(cuda_device, tmp_path,
                                                     monkeypatch, k):
    """``profile_steps (2, 4)`` at K = 1 and as a CUDA graph of 2 steps:
    the chrome trace holds K1 and K1-bwd twice each (steps 3 and 4), no
    profiler is left running, and the losses are bitwise those of the run
    without the window (cuDNN deterministic)."""
    import json

    from distributedpytorch_tpu_torch.train.loop import Trainer

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    runs = {}
    for window in (False, True):
        kw = {"profile_steps": (2, 4)} if window else {}
        trainer = Trainer(_small_config(cuda_device, tmp_path / str(window),
                                        steps_per_dispatch=k, **kw))
        trainer.train()
        runs[window] = [float(x) for x in trainer.records.losses]
    assert runs[True] == runs[False]
    assert not torch.autograd._profiler_enabled()
    path = trainer.profile_window.path
    assert path.endswith("singleGPU.rank0.steps2-4.pt.trace.json")
    with open(path) as f:
        names = [e.get("name", "") for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "kernel"]
    assert sum(bool(re.search(r"\bstats_kernel\b", n)) for n in names) == 2
    assert sum(bool(re.search(r"\bstats_bwd_kernel\b", n))
               for n in names) == 2


def test_the_profiler_window_traces_the_loss_kernels_in_a_fresh_process(
        cuda_device, tmp_path):
    """The training CLI as a child process, whose first profiler session is
    the window's (``python -m distributedpytorch_tpu_torch --synthetic 16
    -b 4 -e 1 --kernels cuda --profile-steps 2:4 --profile-dir D``): its
    chrome trace holds K1 and K1-bwd twice each, steps 3 and 4. A
    process's first session once traced no kernel at all; the window
    warms the profiler up first (``train/loop.warm_profiler``)."""
    import json
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = tmp_path / "profile"
    proc = subprocess.run(
        [sys.executable, "-m", "distributedpytorch_tpu_torch",
         "--synthetic", "16", "-b", "4", "-e", "1", "--kernels", "cuda",
         "--profile-steps", "2:4", "--profile-dir", str(out)],
        cwd=tmp_path, env=dict(os.environ, PYTHONPATH=repo),
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    (path,) = out.iterdir()
    assert path.name == "singleGPU.rank0.steps2-4.pt.trace.json"
    with open(path) as f:
        names = [e.get("name", "") for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "kernel"]
    assert sum(bool(re.search(r"\bstats_kernel\b", n)) for n in names) == 2
    assert sum(bool(re.search(r"\bstats_bwd_kernel\b", n))
               for n in names) == 2


def test_a_ckpt_round_trip_resumes_on_the_card_bitwise(cuda_device,
                                                       tmp_path):
    """A milesial bf16_params run on the card, its checkpoint through
    ``save_jax_ckpt`` and ``load_jax_ckpt``, resumed with ``-c``: the
    weights, the f32 master and Adam's state on the card bit for bit."""
    from distributedpytorch_tpu_torch import checkpoint
    from distributedpytorch_tpu_torch.train.loop import Trainer

    cfg = _small_config(cuda_device, tmp_path, model_arch="milesial",
                        dtype="bf16_params")
    trainer = Trainer(cfg)
    trainer.train()
    saved = checkpoint.load_native(trainer.checkpoint_path)
    path = str(tmp_path / "x.ckpt")
    checkpoint.save_jax_ckpt(saved, path)
    import dataclasses

    again = Trainer(dataclasses.replace(cfg, epochs=2, checkpoint_name=path))
    for name, value in again.model.state_dict().items():
        assert value.device.type == "cuda"
        assert value.dtype == saved["model"][name].dtype
        assert torch.equal(value.cpu(), saved["model"][name]), name
    state = again.optimizer.state_dict()
    for a, b in zip(state["master"], saved["optimizer"]["master"]):
        assert torch.equal(a.cpu(), b)
    inner = saved["optimizer"]["inner"]["state"]
    for i, st in inner.items():
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(state["inner"]["state"][i][key].cpu(), st[key])
    assert np.isfinite(again.train()["val_loss"])
