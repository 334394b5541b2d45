"""The port's classification service (``holocron_tpu_torch.api``) on the CPU: the cases
of ``api/tests/test_app.py`` against the port's stdlib server on 127.0.0.1 with
``HOLOCRON_DEVICE=cpu``, and the pieces held against the JAX service's: the decoded
uint8 image (bit for bit, each decoder present here), the micro-batcher's buckets,
batch sizes and exceptions under one arrival pattern, and the probabilities of the
service's device program on the same weights and images (1e-5)."""

import concurrent.futures as cf
import http.client
import json
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from api.app import batcher as jax_batcher
from api.app import vision as jax_vision
from holocron_tpu.models.classification.repvgg import RepVGG as JaxRepVGG
from holocron_tpu.models.core import Model
from holocron_tpu_torch import bench, convert, quant
from holocron_tpu_torch.api import batcher, config, vision
from holocron_tpu_torch.api.main import serve
from holocron_tpu_torch.api.schemas import ClsCandidate, Status
from holocron_tpu_torch.models import RepVGG
from holocron_tpu_torch.models.core import deploy_forward
from holocron_tpu_torch.models.presets import IMAGENETTE

torch.set_num_threads(2)

ASSET = Path(__file__).resolve().parent / "assets" / "quicktour_golf_ball.jpg"
STAGE_HEADERS = ("X-Decode-Ms", "X-Queue-Ms", "X-Infer-Ms", "X-Batch-Size")


@pytest.fixture
def service_config(monkeypatch):
    """The service's settings for a test (restored after it), with the model and the
    batcher dropped before and after."""
    monkeypatch.setattr(config, "DEVICE", "cpu")
    monkeypatch.setattr(config, "ARCH", "repvgg_a0")
    monkeypatch.setattr(config, "QUANTIZE", False)
    monkeypatch.setattr(config, "CHECKPOINT", "")
    vision.reset()
    yield config
    vision.reset()


@pytest.fixture(scope="module")
def server():
    saved = {k: getattr(config, k) for k in ("DEVICE", "ARCH", "QUANTIZE", "CHECKPOINT")}
    config.DEVICE, config.ARCH, config.QUANTIZE, config.CHECKPOINT = "cpu", "repvgg_a0", False, ""
    vision.reset()
    srv = serve("127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield srv.server_address[1]
    srv.shutdown()
    srv.server_close()
    vision.reset()
    for k, v in saved.items():
        setattr(config, k, v)


def _request(port, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read()), dict(resp.getheaders())
    finally:
        conn.close()


def _jpeg(seed: int, size: int = 64) -> bytes:
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.random.default_rng(seed).integers(0, 255, (size, size, 3)).astype(np.uint8)).save(
        buf, format="JPEG")
    return buf.getvalue()


def test_status(server):
    status, payload, headers = _request(server, "GET", "/status")
    assert status == 200
    assert payload == Status("ok", config.PROJECT_NAME, config.VERSION).model_dump()
    assert "X-Process-Time" in headers


def test_classification_of_the_asset_with_stage_headers(server):
    status, payload, headers = _request(server, "POST", "/classification", body=ASSET.read_bytes(),
                                        headers={"Content-Type": "image/jpeg"})
    assert status == 200
    for key in STAGE_HEADERS:
        assert float(headers[key]) >= 0, headers
    assert float(headers["X-Batch-Size"]) == 1
    assert payload["value"] in IMAGENETTE.classes
    assert 0 <= payload["confidence"] <= 1


def test_closed_loop_times_a_fixed_count_a_client(server):
    """bench_serving's closed loop: each client sends one untimed request, then its
    timed ones, all answered 200; a client never sends fewer than MIN_PER_CLIENT timed
    requests, so no row is a single burst."""
    from holocron_tpu_torch import bench_serving

    assert bench_serving.per_client(100, 64) == bench_serving.MIN_PER_CLIENT
    assert bench_serving.per_client(100, 4) == 25
    row = bench_serving.closed_loop(server, ASSET.read_bytes(), 2, 3)
    assert row["concurrency"] == 2 and row["n"] == 6
    assert 1 <= row["mean_batch_size"] <= 2
    assert 0 < row["e2e_ms_p50"] <= row["e2e_ms_p99"] and row["throughput_rps"] > 0


def test_error_codes(server):
    assert _request(server, "POST", "/classification", body=b"not an image")[0] == 400
    assert _request(server, "POST", "/classification", body=b"")[0] == 422
    assert _request(server, "GET", "/nope")[0] == 404
    # a POST to an unknown route is drained and answered 404, and the connection stays usable
    conn = http.client.HTTPConnection("127.0.0.1", server, timeout=300)
    try:
        conn.request("POST", "/nope", body=b"x" * 1000)
        resp = conn.getresponse()
        resp.read()
        assert resp.status == 404
        conn.request("GET", "/status")
        resp = conn.getresponse()
        assert resp.status == 200 and json.loads(resp.read())["status"] == "ok"
    finally:
        conn.close()


def test_multipart_upload(server):
    """The first file part of a multipart body is classified, as a raw body is."""
    boundary = "holocronboundary"
    body = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\"; filename=\"a.jpg\"\r\n"
            "Content-Type: image/jpeg\r\n\r\n").encode() + ASSET.read_bytes() + f"\r\n--{boundary}--\r\n".encode()
    status, payload, _ = _request(server, "POST", "/classification", body=body,
                                  headers={"Content-Type": f"multipart/form-data; boundary={boundary}"})
    raw = _request(server, "POST", "/classification", body=ASSET.read_bytes())[1]
    assert status == 200 and payload == raw
    # a multipart body without a file part carries no image
    empty = f"--{boundary}\r\nContent-Disposition: form-data; name=\"x\"\r\n\r\n1\r\n--{boundary}--\r\n".encode()
    assert _request(server, "POST", "/classification", body=empty,
                    headers={"Content-Type": f"multipart/form-data; boundary={boundary}"})[0] == 422


def test_classification_schema(server):
    """The response round-trips through the schema (confidence in [0, 1])."""
    status, payload, _ = _request(server, "POST", "/classification", body=_jpeg(1),
                                  headers={"Content-Type": "image/jpeg"})
    assert status == 200
    candidate = ClsCandidate(**payload)
    assert candidate.model_dump() == payload
    with pytest.raises(ValueError):
        ClsCandidate(value="x", confidence=1.5)
    with pytest.raises(TypeError):
        ClsCandidate(value=3, confidence=0.5)


def test_concurrent_requests_micro_batch(server):
    """Concurrent requests coalesce in the micro-batcher and all succeed."""

    def one(seed):
        return _request(server, "POST", "/classification", body=_jpeg(seed), headers={"Content-Type": "image/jpeg"})

    with cf.ThreadPoolExecutor(6) as pool:
        results = list(pool.map(one, range(6)))
    assert all(status == 200 for status, _, _ in results)
    assert all(0 <= payload["confidence"] <= 1 for _, payload, _ in results)


def test_keepalive_reuse_under_concurrency(server):
    """Concurrent clients each reusing one HTTP/1.1 keep-alive connection for several
    requests all succeed, with no more than occasional reconnects."""
    jpeg = _jpeg(0)

    def client(_):
        conn = http.client.HTTPConnection("127.0.0.1", server, timeout=300)
        statuses, reconnects = [], 0
        try:
            for _ in range(3):
                for attempt in (0, 1):
                    try:
                        conn.request("POST", "/classification", body=jpeg, headers={"Content-Type": "image/jpeg"})
                        resp = conn.getresponse()
                        break
                    except (BrokenPipeError, ConnectionResetError, http.client.RemoteDisconnected):
                        if attempt:
                            raise
                        conn.close()
                        conn = http.client.HTTPConnection("127.0.0.1", server, timeout=300)
                        reconnects += 1
                resp.read()
                statuses.append(resp.status)
        finally:
            conn.close()
        return statuses, reconnects

    with cf.ThreadPoolExecutor(4) as pool:
        results = list(pool.map(client, range(4)))
    assert all(s == 200 for statuses, _ in results for s in statuses)
    assert sum(r for _, r in results) <= 4, results


@pytest.mark.parametrize("decoder", ["native", "PIL"])
def test_preprocess_bytes_equals_jax(monkeypatch, decoder):
    """The port's preprocess_bytes equals the JAX service's bit for bit on the asset
    JPEG, through the native decoder and through PIL (the decoder not taken is made
    unavailable to both)."""
    from holocron_tpu.utils import data as jax_data

    from holocron_tpu_torch.utils import data as port_data

    data = ASSET.read_bytes()
    if decoder == "native":
        if not (port_data.native_available() and jax_data.native_available()):
            pytest.skip("the native decoder cannot be built here (no g++ or libjpeg)")
    else:
        pytest.importorskip("PIL")
        monkeypatch.setattr(port_data, "native_available", lambda: False)
        monkeypatch.setattr(jax_data, "native_available", lambda: False)
    got, want = vision.preprocess_bytes(data), np.asarray(jax_vision.preprocess_bytes(data))
    assert got.dtype == np.uint8 and got.shape == (1, 224, 224, 3)
    np.testing.assert_array_equal(got, want)


def test_preprocess_bytes_falls_back_to_pil_for_a_corrupt_jpeg_and_other_formats():
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.full((30, 40, 3), 7, np.uint8)).save(buf, format="PNG")
    out = vision.preprocess_bytes(buf.getvalue())
    assert out.shape == (1, 224, 224, 3) and (out == 7).all()
    with pytest.raises(OSError):  # neither decoder reads it: the route answers 400
        vision.preprocess_bytes(b"\xff\xd8\xff" + b"\x00" * 64)


def _arrivals(batcher_cls, fail_marker: bool):
    """One arrival pattern: a request that the worker takes alone and holds, then six
    followers queued in order while it is busy (max_batch 4, so a batch of 4 and one of
    2). With ``fail_marker`` the third follower makes its batch's model call raise. Returns the model's batch
    sizes, each request's outcome (its batch size and probabilities, or the
    exception), sorted."""
    calls, entered, release = [], threading.Event(), threading.Event()

    def infer(batch):
        calls.append(batch.shape[0])
        if len(calls) == 1:
            entered.set()
            release.wait(30)
        if (batch < 0).any():
            raise RuntimeError("boom")
        return batch.reshape(batch.shape[0], -1)[:, :3] * 2

    b = batcher_cls(infer, max_batch=4, max_wait_ms=20)
    xs = [np.full((2, 2, 3), float(i), np.float32) for i in range(7)]
    if fail_marker:
        xs[3] = -xs[3]
    with cf.ThreadPoolExecutor(7) as pool:
        futures = [pool.submit(b.submit, xs[0])]
        assert entered.wait(30)
        for i, x in enumerate(xs[1:], 1):  # queued one after another, in order
            futures.append(pool.submit(b.submit, x))
            deadline = time.monotonic() + 30
            while b._queue.qsize() < i and time.monotonic() < deadline:
                time.sleep(0.001)
        release.set()
        outcomes = []
        for x, fut in zip(xs, futures):
            try:
                out = fut.result(60)
            except RuntimeError as e:
                outcomes.append(("raised", str(e)))
                continue
            np.testing.assert_array_equal(out["probs"], np.full(3, 2 * x.flat[0], np.float32))
            assert out["queue_ms"] >= 0 and out["infer_ms"] >= 0
            outcomes.append(("batch", out["batch_size"]))
    return calls, sorted(outcomes)


@pytest.mark.parametrize("fail_marker", [False, True], ids=["answers", "exceptions"])
def test_micro_batcher_equals_jax(fail_marker):
    """The same arrival pattern through the JAX service's MicroBatcher and the port's
    gives the same model batch sizes (power-of-two buckets), the same per-request batch
    sizes and the same exceptions, passed to every waiter of the failing batch."""
    port = _arrivals(batcher.MicroBatcher, fail_marker)
    jax_side = _arrivals(jax_batcher.MicroBatcher, fail_marker)
    assert port == jax_side
    assert port[0] == [1, 4, 2]


def test_micro_batcher_close_answers_what_was_queued():
    b = batcher.MicroBatcher(lambda batch: batch.reshape(batch.shape[0], -1), max_batch=2, max_wait_ms=1)
    assert b.submit(np.ones((1, 2), np.float32))["batch_size"] == 1
    b.close()
    assert not b._worker.is_alive()


def test_deploy_forward_matches_jax_softmax_fwd():
    """A narrow RepVGG carried from JAX's variables: the port's deploy_forward on the CPU
    (uint8 NHWC in, /255, mean/std and softmax in the forward) against the JAX
    service's softmax_fwd expression (api/app/vision.py:104-110) on the same uint8
    batch, both reparametrized: probabilities within 1e-5, argmax equal. Batches that
    are not a bucket run as they are."""
    rng = np.random.default_rng(0)
    jm = Model(JaxRepVGG([1, 1], [8, 16], 1.0, 1.0)).init((2, 32, 32, 3), key=jax.random.key(0))
    pm = RepVGG([1, 1], [8, 16], 1.0, 1.0, device="cpu")
    pm.load_state_dict(convert.repvgg_state_dict(jm.variables))
    jm.reparametrize()
    pm.eval().reparametrize()
    u8 = rng.integers(0, 256, (5, 32, 32, 3), dtype=np.uint8)
    mean, std = jnp.asarray(IMAGENETTE.mean, jnp.float32), jnp.asarray(IMAGENETTE.std, jnp.float32)
    fwd = jm.deploy_forward()
    want = np.asarray(jax.nn.softmax(fwd((u8.astype(jnp.float32) * (1.0 / 255.0) - mean) / std), axis=-1))
    port = deploy_forward(pm, (1, 2, 4, 8), 32, (IMAGENETTE.mean, IMAGENETTE.std))
    got = port(torch.from_numpy(u8)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_load_model_quantized_follows_the_verdict(service_config, caplog):
    """HOLOCRON_QUANTIZE=1 serves the int8 form where the card measured it faster
    (repvgg_a0), the float form with a warning where it measured slower (rexnet1_0x)
    or where nothing was measured; "force" quantizes regardless."""
    import logging

    service_config.QUANTIZE = True
    model = vision.load_model("repvgg_a0", 10)
    assert isinstance(model, quant.QuantizedModel)
    out = model(torch.randn(1, 3, 32, 32))
    assert out.shape == (1, 10) and torch.isfinite(out).all() and out.dtype == torch.float32
    for arch, reason in (("rexnet1_0x", "measures 0.98x"), ("rexnet1_3x", "no measured int8 verdict")):
        with caplog.at_level(logging.WARNING):
            model = vision.load_model(arch, 10)
        assert not isinstance(model, quant.QuantizedModel)
        assert any(reason in rec.message for rec in caplog.records), caplog.records
    service_config.QUANTIZE = "force"
    assert isinstance(vision.load_model("rexnet1_3x", 10), quant.QuantizedModel)


@pytest.mark.parametrize("fmt", ["trainer", "state_dict"])
def test_load_model_reads_a_checkpoint(service_config, tmp_path, fmt):
    """HOLOCRON_CHECKPOINT: the port trainer's save format or a bare state_dict."""
    from holocron_tpu_torch.models import repvgg_a0

    src = repvgg_a0(num_classes=10, generator=torch.Generator().manual_seed(7), device="cpu")
    state = src.state_dict()
    path = tmp_path / "model.pt"
    torch.save({"epoch": 1, "step": 2, "min_loss": 0.5, "model": state} if fmt == "trainer" else state, path)
    service_config.CHECKPOINT = str(path)
    model = vision.load_model("repvgg_a0", 10)
    want = src.eval().reparametrize().state_dict()
    got = model.state_dict()
    assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)


def test_service_batcher_on_the_cpu(service_config):
    """get_batcher serves the configured model: uint8 images in, probabilities out."""
    b = vision.get_batcher()
    assert vision.get_batcher() is b
    out = b.submit(vision.preprocess_bytes(ASSET.read_bytes()))
    assert out["probs"].shape == (10,) and abs(float(out["probs"].sum()) - 1) < 1e-5
    label, confidence, timings = vision.classify_image(ASSET.read_bytes())
    assert label in IMAGENETTE.classes and 0 <= confidence <= 1
    assert set(timings) == {"decode_ms", "queue_ms", "infer_ms", "batch_size"}


def test_entry_points_raise_without_a_card(service_config):
    """Without a CUDA device the service and the bench raise unless the CPU is asked for
    (HOLOCRON_DEVICE=cpu, device="cpu"): no quiet fallback. The captured forward runs
    where its model lies, and raises for a model on neither the card nor the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the defaults succeed here")
    model = RepVGG([1], [8], 1.0, 1.0, device="meta").eval()
    with pytest.raises(ValueError, match="meta"):
        deploy_forward(model, (1, 2))
    service_config.DEVICE = "cuda"
    with pytest.raises(RuntimeError, match="HOLOCRON_DEVICE=cpu"):
        vision.load_model()
    with pytest.raises(RuntimeError, match="HOLOCRON_DEVICE=cpu"):
        vision.get_batcher()
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.run("repvgg_a0", batch=2, size=32)
    service_config.DEVICE = "meta"
    with pytest.raises(ValueError):
        config.device()
