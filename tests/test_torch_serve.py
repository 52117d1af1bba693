"""The PyTorch port's serving tier on the CPU against the JAX package's:
a ``.pth`` written by the JAX package's export serves through the port's
engine with the JAX engine's probabilities; then the port's buckets,
server, relaunch supervisor, HTTP surface and CLI on their own."""

import concurrent.futures
import http.client
import io
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

from distributedpytorch_tpu.checkpoint import export_reference_pth
from distributedpytorch_tpu.data.dataset import BasicDataset as JaxBasicDataset
from distributedpytorch_tpu.models.unet import UNet as JaxUNet
from distributedpytorch_tpu.models.unet import init_unet_params
from distributedpytorch_tpu.serve.engine import ServeEngine as JaxServeEngine
from distributedpytorch_tpu_torch.data.dataset import BasicDataset, SampleCache
from distributedpytorch_tpu_torch.serve.engine import engine_from_checkpoint
from distributedpytorch_tpu_torch.serve.server import (
    STATE_SERVING,
    Server,
)

SIZE_WH = (48, 32)  # (W, H) CLI order → input_hw (32, 48)
HW = (32, 48)
WIDTHS = (8, 16)
BUCKETS = (1, 2, 4)
# two float32 forwards summing in different orders
PROB_ATOL = 1e-5
# masks may differ only where the probability is this close to 0.5
MASK_BAND = 1e-4


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """Seeded JAX params exported as a reference ``.pth``, and a JAX serve
    engine (float32 pixel path) over the same params."""
    tmp = tmp_path_factory.mktemp("torch_serve")
    model = JaxUNet(dtype=jnp.float32, widths=WIDTHS, s2d_levels=0)
    params = init_unet_params(model, jax.random.key(3), input_hw=HW)
    export_reference_pth(params, str(tmp / "singleGPU.pth"))
    jax_engine = JaxServeEngine(model, params, None, input_hw=HW,
                                bucket_sizes=BUCKETS)
    return tmp, jax_engine


def _engine(tmp, **kwargs):
    kwargs.setdefault("kernels", "torch")
    return engine_from_checkpoint(
        "singleGPU", checkpoint_dir=str(tmp), image_size=SIZE_WH,
        model_widths=WIDTHS, s2d_levels=0, dtype="f32",
        bucket_sizes=BUCKETS, device="cpu", **kwargs,
    )


@pytest.fixture(scope="module")
def engine(checkpoint):
    tmp, _ = checkpoint
    eng = _engine(tmp, host_cache_mb=16)
    eng.warmup()
    return eng


def _rows(n, seed):
    return np.random.default_rng(seed).random((n, *HW, 3), np.float32)


class TestParityWithJax:
    @pytest.mark.parametrize("n", [1, 3, 4])
    def test_probabilities_and_masks_match_jax_engine(self, checkpoint,
                                                      engine, n):
        _, jax_engine = checkpoint
        batch = _rows(n, n)
        want = jax_engine.infer(batch)
        got = engine.infer(batch)
        assert got.shape == want.shape == (n, *HW)
        np.testing.assert_allclose(got, want, rtol=0, atol=PROB_ATOL)
        diff = engine.postprocess(got) != jax_engine.postprocess(want)
        assert not (diff & (np.abs(want - 0.5) >= MASK_BAND)).any()

    def test_cuda_policy_on_cpu_masks_equal_host_threshold(self, checkpoint,
                                                           engine):
        """``kernels="cuda"`` on a CPU engine ends the forward in the
        mask's plain version: uint8 masks out, equal to the torch
        policy's host threshold of the same probabilities."""
        tmp, _ = checkpoint
        masked = _engine(tmp, kernels="cuda")
        assert masked.kernel_policy.name == "cuda"
        batch = _rows(3, 9)
        got = masked.infer(batch)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(
            got, engine.postprocess(engine.infer(batch)))
        np.testing.assert_array_equal(masked.postprocess(got), got)

    def test_preprocess_matches_jax_dataset(self):
        img = Image.fromarray(
            (np.random.default_rng(0).random((20, 30, 3)) * 255)
            .astype(np.uint8))
        for is_mask in (False, True):
            np.testing.assert_array_equal(
                BasicDataset.preprocess(img, SIZE_WH, is_mask),
                JaxBasicDataset.preprocess(img, SIZE_WH, is_mask),
            )


class TestEngine:
    def test_one_forward_per_bucket(self, engine):
        for replica in engine.replicas:
            assert sorted(replica.compiled) == list(BUCKETS)

    def test_oversized_batch_is_refused(self, engine):
        with pytest.raises(ValueError, match="largest bucket"):
            engine.infer(np.zeros((5, *HW, 3), np.float32))

    def test_unknown_bucket_is_a_key_error(self, engine):
        replica = engine.replicas[0]
        placed = engine.place(replica, np.zeros((3, *HW, 3), np.float32))
        with pytest.raises(KeyError):
            engine.run(replica, placed)

    def test_bucket_forward_refuses_other_shapes(self, engine):
        import torch

        with pytest.raises(ValueError, match="built for"):
            engine.replicas[0].compiled[2](torch.zeros(2, 16, 48, 3))

    def test_padded_rows_do_not_perturb_real_rows(self, engine):
        """Eval forwards are per-sample: each row of a 3-row batch padded
        into the 4-bucket gets the mask of its own 1-bucket run. The
        probabilities are not bitwise equal — the CPU convolution blocks
        its sums by batch size, a few ulp apart — so they are held to
        1e-6 and the masks to equality. On the card cuDNN may pick
        another algorithm per bucket shape; there the probabilities are
        within 1e-3 of each other."""
        batch = _rows(3, 1)
        padded = engine.infer(batch)
        for i in range(3):
            solo = engine.infer(batch[i:i + 1])[0]
            np.testing.assert_allclose(padded[i], solo, rtol=0, atol=1e-6)
            np.testing.assert_array_equal(engine.postprocess(padded[i]),
                                          engine.postprocess(solo))

    def test_preprocess_uses_sample_cache(self, engine, tmp_path):
        path = str(tmp_path / "car.png")
        Image.fromarray(np.full((40, 60, 3), 200, np.uint8)).save(path)
        before = engine.cache.hits
        a = engine.preprocess(path)
        b = engine.preprocess(path)
        assert engine.cache.hits == before + 1
        assert a.shape == (*HW, 3) and a.dtype == np.float32
        np.testing.assert_array_equal(a, b)

    def test_preprocess_rejects_wrong_row_shape(self, engine):
        with pytest.raises(ValueError, match="input row"):
            engine.preprocess(np.zeros((16, 48, 3), np.float32))

    def test_replicas_clamp_to_devices(self, checkpoint):
        tmp, _ = checkpoint
        assert _engine(tmp, replicas=4).num_replicas == 1

    def test_default_device_raises_without_a_card(self, checkpoint):
        import torch

        if torch.cuda.is_available():
            pytest.skip("a card is present")
        tmp, _ = checkpoint
        with pytest.raises(RuntimeError, match="device='cpu'"):
            engine_from_checkpoint("singleGPU", checkpoint_dir=str(tmp),
                                   image_size=SIZE_WH, model_widths=WIDTHS)


def test_sample_cache_budget_and_copy():
    cache = SampleCache(budget_bytes=64)
    row = np.zeros(8, np.float32)  # 32 bytes
    assert cache.put("a", {"image": row})
    assert cache.put("b", {"image": row})
    assert not cache.put("c", {"image": row})  # budget full, no eviction
    row[0] = 1.0
    assert cache.get("a")["image"][0] == 0.0  # stored a copy
    assert cache.get("c") is None
    assert (cache.hits, cache.misses, len(cache)) == (1, 1, 2)


class TestServer:
    def test_submit_round_trips(self, engine):
        server = Server(engine).start()
        try:
            requests = [_rows(1 + i % 3, 20 + i) for i in range(8)]
            with concurrent.futures.ThreadPoolExecutor(4) as pool:
                futures = list(pool.map(server.submit, requests))
            responses = [f.result(60) for f in futures]
            for rows, resp in zip(requests, responses):
                assert resp.ok, resp.reason
                assert resp.request_id
                probs = engine.infer(rows)
                assert len(resp.masks) == len(rows)
                for got, p in zip(resp.masks, probs):
                    assert got.dtype == np.uint8 and got.shape == HW
                    # the server may batch the rows with others: a few
                    # ulp of difference can flip only a pixel at 0.5
                    diff = got != engine.postprocess(p)
                    assert not (diff & (np.abs(p - 0.5) >= 1e-6)).any()
            stats = server.stats()
            assert stats["requests_ok"] == 8
            assert stats["images_ok"] == sum(len(r) for r in requests)
        finally:
            server.stop()

    def test_overload_sheds_with_status_and_bounded_depth(self, engine):
        server = Server(engine, hard_cap_images=4, slo_ms=200.0,
                        eager_when_idle=False, placement_depth=0).start()
        try:
            img = _rows(1, 2)[0]
            futures = [server.submit(img, key=str(i)) for i in range(64)]
            responses = [f.result(60) for f in futures]
            rejected = [r for r in responses if r.status == "rejected"]
            assert rejected
            assert all(r.reason == "overloaded" for r in rejected)
            assert any(r.ok for r in responses)
            assert server.queue.max_depth_seen <= 4
            assert server.stats()["rejected"]["overloaded"] == len(rejected)
        finally:
            server.stop()

    def test_bad_input_is_an_error_response(self, engine):
        server = Server(engine).start()
        try:
            resp = server.submit(np.zeros((5, 5), np.float32)).result(30)
            assert resp.status == "error"
        finally:
            server.stop()

    def test_shutdown_resolves_pending_futures(self, engine):
        server = Server(engine, slo_ms=10_000.0, eager_when_idle=False)
        server.start()
        future = server.submit(_rows(1, 4)[0])
        server.stop(drain=False)
        assert future.result(30).status in ("shutdown", "ok")
        assert server.submit(_rows(1, 4)[0]).result(30).status == "shutdown"

    def test_dead_dispatch_core_relaunches(self, checkpoint):
        tmp, _ = checkpoint
        eng = _engine(tmp)
        real_run = eng.run
        calls = {"n": 0}

        def flaky_run(replica, placed):
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("injected dispatch failure")
            return real_run(replica, placed)

        eng.run = flaky_run
        server = Server(eng, restart_backoff_s=0.01).start()
        try:
            first = server.submit(_rows(1, 5)[0]).result(30)
            assert first.status == "error"
            for _ in range(200):
                if server.core_restarts == 1 and server.state == STATE_SERVING:
                    break
                threading.Event().wait(0.02)
            assert server.core_restarts == 1
            assert server.submit(_rows(1, 6)[0]).result(30).ok
        finally:
            server.stop()

    def test_stats_keep_the_jax_key_set(self, engine):
        server = Server(engine).start()
        try:
            assert server.submit(_rows(1, 7)[0]).result(30).ok
            stats = server.stats()
        finally:
            server.stop()
        assert set(stats) == {
            "requests_ok", "requests_failed", "requests_cached", "rejected",
            "rejected_total", "images_ok", "elapsed_s", "imgs_per_s",
            "p50_ms", "p99_ms", "queue_p50_ms", "bucket_dispatches",
            "pad_ratio", "queue_depth_images", "queue_max_depth_images",
            "queue_hard_cap_images", "replicas", "buckets",
            "weights_version", "state", "core_restarts", "predict_cache",
            "attribution", "aot_cache", "ab", "scaler",
        }
        assert stats["requests_ok"] == 1 and stats["state"] == "serving"
        json.dumps(stats)


def test_http_predict_healthz_stats(engine):
    from distributedpytorch_tpu_torch.serve.cli import make_http_server

    server = Server(engine).start()
    httpd = make_http_server(server, port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1",
                                          httpd.server_address[1], timeout=30)
        conn.request("GET", "/healthz")
        resp = conn.getresponse()
        health = json.loads(resp.read())
        assert resp.status == 200 and health["ready"]
        assert health["buckets"] == list(BUCKETS)
        assert health["fingerprint"]["package"] == "distributedpytorch_tpu_torch"

        img = Image.fromarray(
            (np.random.default_rng(1).random((40, 60, 3)) * 255)
            .astype(np.uint8))
        buf = io.BytesIO()
        img.save(buf, format="PNG")
        conn.request("POST", "/predict", body=buf.getvalue())
        resp = conn.getresponse()
        assert resp.status == 200
        assert resp.getheader("Content-Type") == "image/png"
        assert resp.getheader("X-Request-Id")
        mask = np.asarray(Image.open(io.BytesIO(resp.read())))
        row = engine.preprocess(img)
        np.testing.assert_array_equal(
            mask, engine.postprocess(engine.infer(row[None]))[0])

        conn.request("POST", "/predict", body=b"not an image")
        resp = conn.getresponse()
        resp.read()
        assert resp.status == 400
        conn.request("GET", "/livez")
        resp = conn.getresponse()
        resp.read()
        assert resp.status == 200
        conn.request("GET", "/metrics")  # not ported: no route
        resp = conn.getresponse()
        resp.read()
        assert resp.status == 404
        conn.request("GET", "/stats")
        stats = json.loads(conn.getresponse().read())
        assert stats["requests_ok"] == 1
        conn.close()
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.stop()


def test_cli_config_mapping_and_server_build(checkpoint):
    from distributedpytorch_tpu_torch.serve import cli

    tmp, _ = checkpoint
    args = cli.get_args([
        "-c", "singleGPU", "--checkpoint-dir", str(tmp),
        "--image-size", *map(str, SIZE_WH), "--model-widths", *map(str, WIDTHS),
        "--buckets", "1", "2", "--device", "cpu",
        "--kernels", "cuda", "--queue-cap", "6", "--no-eager",
    ])
    cfg = cli.to_config(args)
    assert cfg.image_size == SIZE_WH and cfg.bucket_sizes == (1, 2)
    assert cfg.queue_cap_images == 6 and not cfg.eager_when_idle
    assert (cfg.device, cfg.kernels) == ("cpu", "cuda")
    server = cli.build_server(args)
    assert server.engine.kernel_policy.name == "cuda"
    assert server.queue.hard_cap_images == 6
    assert server.config is not None


def test_training_entry_point_is_not_ported():
    """Training is the default entry point now and takes every spec the
    JAX package trains with its run control; what a pipeline refuses,
    ``--grad-accum`` under in-stage sharding, exits before any group is
    joined, and the exit says where to look."""
    from distributedpytorch_tpu_torch.__main__ import main

    for method in ("2x2x2@fsdp", "4x2x2@fsdp"):
        with pytest.raises(SystemExit, match="raise --microbatches"):
            main(["-t", method, "--grad-accum", "2"])
