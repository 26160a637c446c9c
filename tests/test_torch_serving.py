"""Deploy and serving of the PyTorch port, on ``device="cpu"``.

Round trip ``export_model`` → ``load_predictor``; the HTTP server on
port 0 with concurrent requests batched 3 rows padded to 4; error
answers; the server's command line.  A response must equal a direct
``Predictor`` call on its row within 1e-5 (a row computed in a padded
batch of 4 against alone: the CPU matrix products may block
differently by batch size).
"""
import json
import os
import shutil
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from incubator_mxnet_tpu_torch.deploy import export_model, load_predictor
from incubator_mxnet_tpu_torch.models.bert import BERTModel
from incubator_mxnet_tpu_torch.serving.admission import (ServingError,
                                                         ShuttingDown)
from incubator_mxnet_tpu_torch.serving.model_repository import ModelRepository
from incubator_mxnet_tpu_torch.serving.server import (InferenceServer,
                                                      health_body)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(vocab_size=100, num_layers=2, units=32, hidden_size=64,
           num_heads=4, max_length=16)
T = 16


def _instances(n, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, CFG["vocab_size"], (n, T)).astype(np.int32)
    types = rng.integers(0, 2, (n, T)).astype(np.int32)
    valid = rng.integers(1, T + 1, (n,)).astype(np.int32)
    return tokens, types, valid


@pytest.fixture(scope="module")
def model():
    return BERTModel(**CFG).initialize(
        device="cpu", generator=torch.Generator().manual_seed(0)).eval()


@pytest.fixture(scope="module")
def prefix(model, tmp_path_factory):
    p = str(tmp_path_factory.mktemp("artifact") / "bert")
    export_model(model, [a[:1] for a in _instances(1)], p, kwargs=CFG,
                 outputs=[1])
    return p


def _post(port, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_meta_records_inputs_factory_and_served_outputs(prefix):
    with open(prefix + ".meta.json") as f:
        meta = json.load(f)
    assert meta["inputs"] == [{"shape": [1, T], "dtype": "int32"},
                              {"shape": [1, T], "dtype": "int32"},
                              {"shape": [1], "dtype": "int32"}]
    assert meta["model"] == {
        "factory": "incubator_mxnet_tpu_torch.models.bert:BERTModel",
        "kwargs": CFG}
    assert meta["outputs"] == [{"index": 1, "shape": [1, 2],
                                "dtype": "float32"}]


def test_round_trip_matches_model(model, prefix):
    pred = load_predictor(prefix, device="cpu")
    inputs = _instances(5, seed=1)
    (got,) = pred(*inputs)
    with torch.inference_mode():
        want = model(*(torch.from_numpy(a) for a in inputs))[1].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert not pred.model.training


def test_predictor_rejects_bad_inputs(prefix):
    pred = load_predictor(prefix, device="cpu")
    tokens, types, valid = _instances(2)
    with pytest.raises(ValueError, match="instance shape"):
        pred(tokens[:, :8], types, valid)
    with pytest.raises(ValueError, match="dtype"):
        pred(tokens.astype(np.int64), types, valid)
    with pytest.raises(ValueError, match="3 inputs"):
        pred(tokens, types)


def test_export_checks_the_factory(model, tmp_path):
    inputs = [a[:1] for a in _instances(1)]
    with pytest.raises(ValueError, match="does not rebuild"):
        export_model(model, inputs, str(tmp_path / "m"),
                     kwargs=dict(CFG, num_layers=3))


def test_load_accepts_only_factories_of_the_package(prefix, tmp_path):
    with open(prefix + ".meta.json") as f:
        meta = json.load(f)
    meta["model"]["factory"] = "collections:OrderedDict"
    bad = str(tmp_path / "bad")
    with open(bad + ".meta.json", "w") as f:
        json.dump(meta, f)
    shutil.copy(prefix + ".params.npz", bad + ".params.npz")
    with pytest.raises(ValueError, match="inside"):
        load_predictor(bad, device="cpu")


def test_server_batches_pads_and_answers(prefix, monkeypatch):
    # three concurrent requests fill a batch of 3, which pads to bucket 4
    monkeypatch.setenv("MXNET_SERVING_MAX_BATCH", "3")
    monkeypatch.setenv("MXNET_SERVING_MAX_LATENCY_MS", "30000")
    server = InferenceServer(port=0, buckets=[1, 2, 4], device="cpu")
    try:
        server.repository.load("bert", prefix)
        port = server.start()
        tokens, types, valid = _instances(3, seed=2)
        results = [None] * 3

        def send(i):
            results[i] = _post(port, "/v1/models/bert:predict", {
                "inputs": [tokens[i].tolist(), types[i].tolist(),
                           int(valid[i])]})

        threads = [threading.Thread(target=send, args=(i,))
                   for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        entry = server.repository.get("bert")
        assert dict(entry.batcher.batches) == {(3, 4): 1}
        for i, (code, body) in enumerate(results):
            assert code == 200, body
            (direct,) = entry.predictor(tokens[i:i + 1], types[i:i + 1],
                                        valid[i:i + 1])
            np.testing.assert_allclose(np.asarray(body["outputs"][0]),
                                       direct[0], rtol=1e-5, atol=1e-5)
            assert set(body["timing"]) == {"queue_ms", "compute_ms"}

        code, body = _post(port, "/v1/models/bert:predict", {
            "inputs": [tokens[0][:8].tolist(), types[0].tolist(), 3]})
        assert code == 400 and body["error"] == "BadRequest"
        code, body = _post(port, "/v1/models/bert:predict", {"inputs": [1]})
        assert code == 400
        code, body = _post(port, "/v1/models/nope:predict", {"inputs": []})
        assert code == 404 and body["error"] == "ModelNotFound"
        code, body = _get(port, "/healthz")
        assert code == 200 and body["status"] == "ok"
        assert body["models"]["bert"]["state"] == "ready"
        assert server.repository.unload("bert") == {"unloaded": "bert"}
        code, body = _post(port, "/v1/models/bert:predict", {
            "inputs": [tokens[0].tolist(), types[0].tolist(), 3]})
        assert code == 404
    finally:
        server.shutdown()


def test_server_command_line_serves(prefix):
    env = dict(os.environ, PYTHONPATH=REPO,
               MXNET_SERVING_BATCH_BUCKETS="1,2")
    proc = subprocess.Popen(
        [sys.executable, "-m", "incubator_mxnet_tpu_torch.serving.server",
         "--model", f"bert={prefix}", "--port", "0", "--host", "127.0.0.1",
         "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
    try:
        port = None
        for line in proc.stdout:
            if "listening on" in line:
                port = int(line.split("listening on ")[1].split()[0]
                           .rsplit(":", 1)[1])
                break
        assert port is not None, "server did not start"
        tokens, types, valid = _instances(1, seed=3)
        code, body = _post(port, "/v1/models/bert:predict", {
            "inputs": [tokens[0].tolist(), types[0].tolist(),
                       int(valid[0])]})
        assert code == 200 and len(body["outputs"][0]) == 2
        proc.terminate()
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_drain_stops_admission(prefix):
    repo = ModelRepository(buckets=[1], device="cpu")
    repo.load("bert", prefix)
    tokens, types, valid = _instances(1, seed=4)
    inst = (tokens[0], types[0], valid[0])
    out, timing = repo.predict_async("bert", inst).result()
    assert out[0].shape == (2,) and timing["compute_ms"] > 0
    with pytest.raises(ServingError, match="already loaded"):
        repo.load("bert", prefix)
    repo.drain_all()
    code, body = health_body(repo)
    assert code == 503 and body["models"]["bert"]["state"] == "draining"
    with pytest.raises(ShuttingDown):
        repo.predict_async("bert", inst)
