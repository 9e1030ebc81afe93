"""egm_unet_torch's two serving entry points on the CPU.

``cli/serve.py``: the cases of tests/test_serve.py (PNG in, PNG {0, 255}
mask out at the original resolution, request coalescing, health and stats,
the lone-client rule, a full queue, bad requests) against the port's server,
then the HTTP masks against ``Predictor.predict`` on the same images and
against the JAX package's ``Predictor`` on the same weights (>= 99.9% of
pixels: an argmax can flip where two logits tie within float32 roundoff).

``cli/predict.py``: four {0, 255} PNGs under the JAX CLI's names, and masks
that agree with ``egm_unet_tpu.cli.predict`` on the same weights."""

import http.client
import io
import json
import sys
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import egm_unet_tpu.engine as jengine
from egm_unet_tpu.cli.predict import main as jpredict_main
from egm_unet_tpu.models import create_model as jcreate
from egm_unet_tpu.serving import Predictor as JPredictor
from egm_unet_tpu.serving import PredictorConfig as JConfig

from egm_unet_torch.cli.predict import main as predict_main
from egm_unet_torch.cli.predict import parse_args as predict_parse_args
from egm_unet_torch.cli.serve import MicroBatcher, make_server, parse_args
from egm_unet_torch.data.synthetic import synthetic_tp_sample
from egm_unet_torch.models import create_model
from egm_unet_torch.serving import Predictor, PredictorConfig
from egm_unet_torch.utils import state_dict_from_flax

from tests.torch_port_util import random_variables

SERVER_ARGS = ["--init-random", "--model", "unet", "--base-c", "8",
               "--base-size", "64", "--batch-size", "4",
               "--batch-window-ms", "30", "--port", "0", "--dtype", "float32",
               "--device", "cpu"]


def _serve(args, predictor=None):
    httpd, batcher = make_server(args, predictor)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, batcher


@pytest.fixture(scope="module")
def server():
    httpd, batcher = _serve(parse_args(SERVER_ARGS))
    yield httpd.server_port, batcher
    httpd.shutdown()
    batcher.shutdown()
    httpd.server_close()


def _png(image):
    buf = io.BytesIO()
    Image.fromarray(image).save(buf, format="PNG")
    return buf.getvalue()


def _post(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    conn.request("POST", "/predict", body=body, headers={"Content-Type": "image/png"})
    resp = conn.getresponse()
    out = resp.read()
    conn.close()
    return resp.status, resp.getheader("Content-Type"), out


def _post_image(port, h=50, w=70, seed=0):
    rng = np.random.default_rng(seed)
    return _post(port, _png(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)))


def _post_all(port, images):
    """POST every image from its own thread; the decoded masks, in order."""
    results = [None] * len(images)

    def worker(i):
        results[i] = _post(port, _png(images[i]))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(images))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert all(r is not None and r[0] == 200 for r in results)
    return [np.asarray(Image.open(io.BytesIO(r[2]))) for r in results]


def test_predict_roundtrip(server):
    port, _ = server
    status, ctype, body = _post_image(port)
    assert status == 200 and ctype == "image/png"
    mask = np.asarray(Image.open(io.BytesIO(body)))
    assert mask.shape == (50, 70)  # original resolution, not the bucket
    assert set(np.unique(mask)) <= {0, 255}


def test_concurrent_requests_coalesce(server):
    port, batcher = server
    before = batcher.n_batches
    rng = np.random.default_rng(1)
    images = [rng.integers(0, 255, (40 + i, 60, 3), dtype=np.uint8) for i in range(4)]
    masks = _post_all(port, images)
    for i, mask in enumerate(masks):
        assert mask.shape == (40 + i, 60)
    # 4 simultaneous posts within the 30 ms window take fewer than 4
    # dispatches (one 64-pixel bucket: typically 1)
    assert batcher.n_batches - before < 4


def test_health_and_stats(server):
    port, _ = server
    _post_image(port, seed=2)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", "/healthz")
    assert conn.getresponse().read() == b"ok"  # a request has been answered
    conn.request("GET", "/stats")
    stats = json.loads(conn.getresponse().read())
    assert stats["requests"] >= 1 and stats["batches"] >= 1
    assert stats["mean_batch_occupancy"] >= 1.0
    assert stats["mean_device_ms"] > 0 and stats["mean_queue_ms"] >= 0
    lat = stats["latency_ms"]
    assert lat["p50"] > 0 and lat["p50"] <= lat["p95"] <= lat["p99"]
    conn.close()


class _FakePredictor:
    """Deterministic stand-in: records batch sizes, sleeps a fixed 10 ms."""

    def __init__(self):
        self.batches = []

    def predict(self, images):
        self.batches.append(len(images))
        time.sleep(0.01)
        return [np.zeros((2, 2), np.int32) for _ in images]


def test_lone_client_skips_window():
    # a lone request must not pay the batching window: 200 ms would show
    b = MicroBatcher(_FakePredictor(), max_batch=4, window_ms=200.0)
    try:
        img = np.zeros((4, 4, 3), np.uint8)
        t0 = time.perf_counter()
        b.predict(img)
        dt = time.perf_counter() - t0
        assert dt < 0.15, f"lone request paid the window: {dt * 1e3:.0f} ms"
        assert b.queue_time_s < 0.15 and b.device_time_s > 0
        assert b.stats()["n_requests"] == 1 and b.latency_ms()["p50"] > 0
    finally:
        b.shutdown()


def test_full_queue_dispatches_before_window():
    # queue == capacity must dispatch at once even in burst mode
    fake = _FakePredictor()
    b = MicroBatcher(fake, max_batch=4, window_ms=10_000.0)
    b._prev_occupancy = 4  # burst mode: the window would otherwise apply
    try:
        img = np.zeros((4, 4, 3), np.uint8)
        results = [None] * 4
        threads = [threading.Thread(
            target=lambda i=i: results.__setitem__(i, b.predict(img)))
            for i in range(4)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        dt = time.perf_counter() - t0
        assert all(r is not None for r in results)
        assert dt < 5.0, f"capacity batch waited on the 10 s window: {dt:.1f} s"
        assert max(fake.batches) >= 2  # they really coalesced
    finally:
        b.shutdown()


def test_batcher_loses_no_request_under_contention():
    """More client threads than cores, a short switch interval: every request
    gets its own answer and the locked counters add up."""
    class Echo:
        def predict(self, images):
            return [img[0, 0, :1].copy() for img in images]

    b = MicroBatcher(Echo(), max_batch=8, window_ms=1.0)
    n_threads, per_thread = 32, 12
    got = [[None] * per_thread for _ in range(n_threads)]

    def client(t):
        for j in range(per_thread):
            img = np.full((2, 2, 3), (t * per_thread + j) % 251, np.uint8)
            got[t][j] = int(b.predict(img, timeout=60)[0])

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(t,)) for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        b.shutdown()
    total = n_threads * per_thread
    assert got == [[(t * per_thread + j) % 251 for j in range(per_thread)]
                   for t in range(n_threads)]
    stats = b.stats()
    assert stats["n_requests"] == stats["n_batched_items"] == total
    assert 1 <= stats["n_batches"] <= total and len(b._latencies) == total


def test_bad_request_is_400(server):
    port, _ = server
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("POST", "/predict", body=b"not an image")
    assert conn.getresponse().status == 400
    conn.request("POST", "/nope", body=b"")
    assert conn.getresponse().status == 404
    conn.request("GET", "/nope")
    assert conn.getresponse().status == 404
    conn.close()


def test_predictor_failure_reaches_every_waiter():
    class Failing:
        def predict(self, images):
            raise RuntimeError("boom")

    b = MicroBatcher(Failing(), max_batch=2, window_ms=1.0)
    try:
        with pytest.raises(RuntimeError, match="boom"):
            b.predict(np.zeros((4, 4, 3), np.uint8))
    finally:
        b.shutdown()


def test_parsers_carry_the_route_flags():
    args = parse_args(["--conv-impl", "pair", "--upsample-impl", "fused"])
    assert (args.conv_impl, args.upsample_impl, args.device) == ("pair", "fused", None)
    assert args.quant is None  # full precision unless asked
    assert [parse_args(["--quant", q]).quant for q in ("int8", "int8df", "int8full")] \
        == ["int8", "int8df", "int8full"]  # the JAX CLI's choices
    with pytest.raises(SystemExit):
        parse_args(["--quant", "int4"])
    args = parse_args([])
    assert (args.conv_impl, args.upsample_impl, args.batch_size) == ("gemm", "matmul", 128)
    pargs = predict_parse_args(["--conv-impl", "pair", "--device", "cpu"])
    assert (pargs.conv_impl, pargs.upsample_impl, pargs.device) == ("pair", "matmul", "cpu")
    with pytest.raises(SystemExit):
        parse_args(["--conv-impl", "pallas"])


def test_server_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_server(parse_args(["--init-random", "--port", "0"]))


def test_http_masks_match_predictor_and_jax():
    """The pair / fused route behind the server, on weights bridged from the
    JAX package: what the HTTP clients get is what ``Predictor.predict`` gives,
    and agrees with the JAX ``Predictor``."""
    images = [synthetic_tp_sample(i, h, w)[0]
              for i, (h, w) in enumerate([(40, 52), (48, 48), (30, 90), (44, 52)])]
    v = random_variables(jcreate("egm_unet", base_c=8), jnp.zeros((1, 64, 64, 3)),
                         train=True, seed=3)
    kw = dict(base_c=8, batch_size=4, base_size=32, dtype="float32")
    pred = Predictor(v, PredictorConfig(conv_impl="pair", upsample_impl="fused", **kw),
                     device="cpu")
    args = parse_args(["--batch-size", "4", "--batch-window-ms", "30", "--port", "0"])
    httpd, batcher = _serve(args, pred)
    try:
        got = _post_all(httpd.server_port, images)
    finally:
        httpd.shutdown()
        batcher.shutdown()
        httpd.server_close()
    direct = pred.predict(images)
    ref = JPredictor(v, JConfig(**kw)).predict(images)
    agree = total = 0
    for img, g, d, r in zip(images, got, direct, ref):
        assert g.shape == img.shape[:2] and set(np.unique(g)) <= {0, 255}
        np.testing.assert_array_equal(g, d * 255)
        agree += int(((g > 0) == (r > 0)).sum())
        total += g.size
    assert agree / total >= 0.999, agree / total
    assert 0 < sum(int((g > 0).sum()) for g in got) < total


def test_from_checkpoint_loads_a_state_dict(tmp_path):
    cfg = PredictorConfig(model_name="unet", base_c=8, batch_size=1, base_size=32,
                          dtype="float32", conv_impl="pair")
    src = create_model("unet", base_c=8, generator=torch.Generator().manual_seed(7))
    path = tmp_path / "unet.pt"
    torch.save(src.state_dict(), path)  # saved on the default route
    pred = Predictor.from_checkpoint(str(path), cfg, device="cpu")
    for (k, a), b in zip(src.state_dict().items(), pred.model.state_dict().values()):
        assert torch.equal(a, b), k
    with pytest.raises(RuntimeError, match="Missing key|Unexpected key"):
        torch.save({"nope": torch.zeros(1)}, path)
        Predictor.from_checkpoint(str(path), cfg, device="cpu")


def test_predict_cli_matches_jax_cli(tmp_path, monkeypatch, capsys):
    """Both CLIs on ``--synthetic`` without a checkpoint.  The JAX CLI draws
    its weights with ``jax.random.key(0)``; the test draws the same tree
    (under ``jax.jit``: an eager init of the whole model takes a minute on
    the CPU), hands it to the JAX CLI in place of its own init, and bridges
    it into a state_dict file for the port's ``--weights``."""
    jmodel = jcreate("egm_unet", num_classes=2, base_c=8)
    v = jax.jit(lambda key: jmodel.init(key, jnp.zeros((1, 64, 64, 3)), train=True))(
        jax.random.key(0))
    v = jax.tree_util.tree_map(np.asarray, dict(v))
    state = types.SimpleNamespace(params=v["params"], batch_stats=v["batch_stats"])
    monkeypatch.setattr(jengine, "create_train_state", lambda *a, **k: state)
    common = ["--synthetic", "--base-c", "8", "--base-size", "64"]
    jpredict_main([*common, "--weights", str(tmp_path / "none"),
                   "--save-result", str(tmp_path / "jax")])

    weights = tmp_path / "egm_unet.pt"
    torch.save(state_dict_from_flax(create_model("egm_unet", base_c=8), v), weights)
    capsys.readouterr()
    predict_main([*common, "--weights", str(weights), "--device", "cpu",
                  "--conv-impl", "pair", "--upsample-impl", "fused",
                  "--save-result", str(tmp_path / "port")])
    out = capsys.readouterr().out
    assert f"loaded weights from {weights}" in out
    assert out.count("inference time: ") == 4 and out.splitlines()[-1].startswith("FPS: ")

    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == ["0000.png", "0001.png", "0002.png", "0003.png"]
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == names
    agree = total = 0
    for name in names:
        ref = np.asarray(Image.open(tmp_path / "jax" / name))
        got = np.asarray(Image.open(tmp_path / "port" / name))
        assert got.shape == (565, 752) and got.dtype == np.uint8
        assert set(np.unique(got)) <= {0, 255}
        agree += int((got == ref).sum())
        total += got.size
    assert agree / total >= 0.999, agree / total


def test_predict_cli_without_checkpoint_warns(tmp_path, capsys):
    predict_main(["--synthetic", "--model", "unet", "--base-c", "8", "--base-size", "32",
                  "--device", "cpu", "--amp", "--weights", str(tmp_path / "none"),
                  "--save-result", str(tmp_path / "out")])
    out = capsys.readouterr().out
    assert "WARNING: no checkpoint dir found; using random init" in out
    assert len(list((tmp_path / "out").glob("*.png"))) == 4
