"""The port's HTTP server (python -m cfen_vit_tpu_torch.serve) and eval CLI
(python -m cfen_vit_tpu_torch.eval) on the CPU (--gpu_ids -1): the cases
of tests/test_serve.py and tests/test_eval_cli.py, a served reply against
the JAX DehazingModel on the same .pth (bar 2/255 per pixel, the .pth
CLI bar), and the eval CLI against the repository's eval.py on the same
folders of 256 px images (PSNR within 1e-4 dB, SSIM within 1e-5, MS-SSIM
within 1e-4; both print values rounded to 4 and 5 decimals).
"""

import http.server
import io
import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from cfen_vit_tpu_torch import eval as port_eval
from cfen_vit_tpu_torch import serve
from tests.ref_utils import load_repo_module

TINY = ["--n_feats", "8", "--loadSize", "64", "--patch_size", "8",
        "--num_heads", "2", "--hidden_dim_ratio", "2"]
HEALTHZ_KEYS = {"status", "model", "input_size", "requests", "batches",
                "max_batch_seen", "mean_latency_ms", "mean_device_ms_per_batch",
                "uptime_s", "device_s_total", "batched_reqs_total",
                "device_util_pct", "device_req_s_ceiling"}


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A seeded tiny v3 generator with its ActNorms initialised, saved as
    srv/5_net_G.pth; returns the server's argv."""
    from dataclasses import replace
    from cfen_vit_tpu_torch.models.generator import Generator, init_weights
    from cfen_vit_tpu_torch.models.registry import generator_spec
    tmp = tmp_path_factory.mktemp("port_serve")
    spec = replace(generator_spec("iid_hlgvit_crs_gd4_cfs_v3"), n_feats=8,
                   load_size=64, patch_size=8, num_heads=2, hidden_dim_ratio=2)
    net = init_weights(Generator(spec), torch.Generator().manual_seed(3)).eval()
    with torch.no_grad():
        net(torch.from_numpy(np.random.RandomState(5).uniform(
            -1, 1, (2, 3, 128, 128)).astype(np.float32)))
    (tmp / "srv").mkdir()
    torch.save(net.state_dict(), tmp / "srv" / "5_net_G.pth")
    return ["--name", "srv", "--checkpoints_dir", str(tmp), "--dataroot", str(tmp),
            "--which_epoch", "5", *TINY]


def _start(cfg, model, size, **kw):
    stats = serve.Stats()
    handler = serve.make_handler(cfg, model, size, stats, **kw)
    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, handler, stats


@pytest.fixture(scope="module")
def server(ckpt):
    cfg, model, size = serve.build_model(ckpt + ["--gpu_ids", "-1"])
    serve.warm(cfg, model, size, 4)
    httpd, handler, stats = _start(cfg, model, size)
    yield {"url": f"http://127.0.0.1:{httpd.server_port}", "model": model,
           "cfg": cfg, "stats": stats}
    httpd.shutdown()
    handler.batcher.close()


def _png(img):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "PNG")
    return buf.getvalue()


def _post(url, body):
    req = urllib.request.Request(f"{url}/dehaze", data=body, method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return np.asarray(Image.open(io.BytesIO(r.read()))), dict(r.headers)


def test_build_model_forces_out_all_on_the_cpu(server):
    assert server["cfg"].out_all and server["model"].branches == "d"
    assert server["model"].device == torch.device("cpu")
    assert server["model"]._u8_io


def test_healthz(server):
    with urllib.request.urlopen(f"{server['url']}/healthz") as r:
        data = json.loads(r.read())
    assert set(data) == HEALTHZ_KEYS
    assert data["status"] == "ok" and data["input_size"] == 128
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"{server['url']}/nothing")
    assert e.value.code == 404


def test_dehaze_roundtrip(server, rng):
    out, headers = _post(server["url"], _png((rng.rand(128, 128, 3) * 255).astype(np.uint8)))
    assert headers["Content-Type"] == "image/png"
    assert out.shape == (128, 128, 3)
    for h in ("X-Latency-Ms", "X-Decode-Ms", "X-Model-Ms", "X-Encode-Ms"):
        assert float(headers[h]) >= 0.0, h


def test_dehaze_resizes_mismatched_input(server, rng):
    out, _ = _post(server["url"], _png((rng.rand(200, 300, 3) * 255).astype(np.uint8)))
    assert out.shape == (128, 128, 3)


def test_dehaze_rejects_garbage(server):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server["url"], b"not an image")
    assert e.value.code == 400


def test_dehaze_content_matches_model(server, rng):
    """The served PNG is the model's own uint8 fake_A, byte for byte, and
    not the saturated image a second [-1,1] -> uint8 conversion gives."""
    pix = (rng.rand(128, 128, 3) * 255).astype(np.uint8)
    got, _ = _post(server["url"], _png(pix))
    model = server["model"]
    model.set_input({"B": pix[None].astype(np.float32) / 255.0 * 2 - 1, "B_paths": ["t"]})
    want = model.test()["fake_A"][0]
    assert want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert (got == 255).mean() < 0.5


def test_reply_matches_the_jax_model(server, ckpt, rng):
    """The JAX DehazingModel reads the same .pth; the reply is within 2/255."""
    from cfen_vit_tpu.config import parse_args as jax_parse_args
    from cfen_vit_tpu.models.dehazing_model import DehazingModel as JaxModel
    pix = (rng.rand(128, 128, 3) * 255).astype(np.uint8)
    got, _ = _post(server["url"], _png(pix))
    cfg = jax_parse_args(ckpt + ["--out_all"], is_train=False, save_opt=False)
    jm = JaxModel(cfg)
    jm.setup(cfg)
    jm.set_input({"B": pix[None], "B_paths": ["t"]})
    want = jm.test(cfg)["fake_A"][0]
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 2


def test_model_input_normalizes_float_path(rng):
    class M:
        pass

    u8 = (rng.rand(2, 8, 8, 3) * 255).astype(np.uint8)
    m = M()
    m._u8_io = True
    assert serve._model_input(m, u8) is u8
    m._u8_io = False
    f = serve._model_input(m, u8)
    assert f.dtype == np.float32
    np.testing.assert_allclose(f, u8.astype(np.float32) / 127.5 - 1.0)


def test_warm_batch_shapes_cover_non_pow2():
    assert serve._batch_shapes(4) == [1, 2, 4]
    assert serve._batch_shapes(6) == [1, 2, 4, 6]
    assert serve._batch_shapes(1) == [1]


def test_concurrent_requests_batch(server, rng):
    """Simultaneous posts within a 300 ms window share one forward."""
    httpd, handler, stats = _start(server["cfg"], server["model"], 128,
                                   max_batch=4, window_ms=300.0)
    url = f"http://127.0.0.1:{httpd.server_port}"
    try:
        bodies = [_png((rng.rand(128, 128, 3) * 255).astype(np.uint8)) for _ in range(4)]
        outs = [None] * 4

        def post(i):
            outs[i] = _post(url, bodies[i])[0]
        threads = [threading.Thread(target=post, args=(i,)) for i in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        assert all(o is not None and o.shape == (128, 128, 3) for o in outs)
        assert stats.get("max_seen", 0) >= 2, stats._d
        assert stats.get("batched_reqs") == 4
    finally:
        httpd.shutdown()
        handler.batcher.close()
    assert not handler.batcher._thread.is_alive()


def test_self_ensemble_server_takes_the_float_path(ckpt, rng):
    """--self_ensemble turns the uint8 wire off: the batcher hands
    set_input [-1, 1] floats and converts the float32 fake_A itself."""
    cfg, model, size = serve.build_model(ckpt + ["--gpu_ids", "-1", "--self_ensemble"])
    assert not model._u8_io
    httpd, handler, _ = _start(cfg, model, size, max_batch=1)
    try:
        pix = (rng.rand(128, 128, 3) * 255).astype(np.uint8)
        got, _ = _post(f"http://127.0.0.1:{httpd.server_port}", _png(pix))
    finally:
        httpd.shutdown()
        handler.batcher.close()
    model.set_input({"B": serve._model_input(model, pix[None]), "B_paths": ["t"]})
    np.testing.assert_array_equal(got, serve._to_u8(model.test(cfg)["fake_A"][0]))


def test_entry_points_ask_for_cuda_by_default(ckpt, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.build_model(ckpt)
    (tmp_path / "a.png").write_bytes(_png(np.zeros((8, 8, 3), np.uint8)))
    with pytest.raises(RuntimeError, match="CUDA"):
        port_eval.main(["--pred", str(tmp_path), "--gt", str(tmp_path)])


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    """3 ground-truth 256 px images and noisy, blurred predictions of them
    named <stem>_fake_A.png."""
    rng = np.random.RandomState(8)
    root = tmp_path_factory.mktemp("eval")
    (root / "pred").mkdir()
    (root / "gt").mkdir()
    for i in range(3):
        low = rng.rand(16, 16, 3)
        gt = np.kron(low, np.ones((16, 16, 1))) * 255
        pred = np.clip(gt + rng.randn(256, 256, 3) * 4 * (i + 1), 0, 255)
        Image.fromarray(gt.astype(np.uint8)).save(root / "gt" / f"im{i}.png")
        Image.fromarray(pred.astype(np.uint8)).save(root / "pred" / f"im{i}_fake_A.png")
    return root


def _eval_json(mod, argv, capsys):
    assert mod.main(argv + ["--json"]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_eval_cli_matches_eval_py(folders, capsys):
    argv = ["--pred", str(folders / "pred"), "--gt", str(folders / "gt"), "--msssim"]
    want = _eval_json(load_repo_module("eval"), argv, capsys)
    got = _eval_json(port_eval, argv + ["--gpu_ids", "-1"], capsys)
    assert got["n"] == want["n"] == 3
    assert abs(got["psnr"] - want["psnr"]) <= 1e-4 + 1e-9
    assert abs(got["ssim"] - want["ssim"]) <= 1e-5 + 1e-12
    assert abs(got["msssim"] - want["msssim"]) <= 1e-4 + 1e-12
    assert 20 < got["psnr"] < 60 and 0 < got["ssim"] < 1


def test_eval_cli_text_line_and_no_pairs(folders, tmp_path, capsys):
    assert port_eval.main(["--pred", str(folders / "pred"), "--gt", str(folders / "gt"),
                           "--gpu_ids", "-1"]) == 0
    assert capsys.readouterr().out.startswith("n=3 PSNR=")
    empty = tmp_path / "empty"
    empty.mkdir()
    assert port_eval.main(["--pred", str(empty), "--gt", str(folders / "gt"),
                           "--gpu_ids", "-1"]) == 2


def test_eval_empty_suffix_pairs_nothing_as_eval_py_does(folders, tmp_path):
    """--suffix '' strips the whole stem in eval.py (stem[:-0] is ''), so
    files with equal names never pair; the port keeps that (ROADMAP
    Queue C)."""
    for name in ("pred", "gt"):
        (tmp_path / name).mkdir()
        Image.open(folders / "gt" / "im0.png").save(tmp_path / name / "im0.png")
    argv = ["--pred", str(tmp_path / "pred"), "--gt", str(tmp_path / "gt"), "--suffix", ""]
    assert load_repo_module("eval").main(argv) == 2
    assert port_eval.main(argv + ["--gpu_ids", "-1"]) == 2
