"""The port's surrogate gateway against the reference's, on the CPU.

One snapshot is trained by the reference (JAX) and carried across with
``convert.snapshot_from_jax`` (its members, rows, version and bundle
cursor), so both gateways answer from one model.  The same requests go to
both over localhost HTTP: the statuses must be equal, and the predict,
calibrate and what-if bodies equal within rel 1e-4 of each field's largest
magnitude (float32 forwards in two frameworks).  After a new bundle, both
refreshes fold the same rows in (each package then trains its own model).

The nine cases of ``tests/test_serve_gateway.py`` run against the port in
``test_torch_ref_serve_gateway.py``."""
import http.client
import json

import numpy as np
import pytest

from repro.core.active import SurrogateSnapshot as Snapshot_ref
from repro.core.bundler import Bundler as Bundler_ref
from repro.serve.gateway import SurrogateGateway as Gateway_ref
from repro_torch import convert
from repro_torch.serve.gateway import SurrogateGateway

pytestmark = pytest.mark.serve

REL = 1e-4


def _request(port, method, path, body=None, timeout=30.0):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        payload = None if body is None else (
            body if isinstance(body, bytes) else json.dumps(body))
        conn.request(method, path, body=payload,
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        raw = r.read()
        return r.status, (json.loads(raw) if raw else {})
    finally:
        conn.close()


def _archive(root, lo, hi, seed):
    rng = np.random.default_rng(seed)
    X = rng.random((hi - lo, 3)).astype(np.float32)
    y = (np.sin(3.0 * X[:, 0]) + 0.5 * X[:, 1]).astype(np.float32)
    Bundler_ref(root).write_bundle(lo, hi, {"inputs": X, "yield": y})
    return X


def _close(got, want, path=""):
    """Same structure; numbers within REL of the largest magnitude of
    their list (or of themselves)."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        flat = np.asarray(want, float) if want and not isinstance(
            want[0], (dict, list)) else None
        if flat is not None:
            g = np.asarray(got, float)
            scale = max(float(np.abs(flat).max()), 1e-30)
            assert np.abs(g - flat).max() <= REL * scale, path
        else:
            for i, (g, w) in enumerate(zip(got, want)):
                _close(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert abs(got - want) <= REL * max(abs(want), 1e-30), path
    else:
        assert got == want, path


REQUESTS = [
    ("GET", "/healthz", None),
    ("POST", "/v1/predict", {"points": [[0.1, 0.2, 0.3], [0.9, 0.5, 0.0]]}),
    ("POST", "/v1/predict", {"points": [0.5, 0.5, 0.5]}),
    ("POST", "/v1/calibrate", {"target": 0.5, "n_candidates": 64,
                               "top_k": 3, "seed": 7}),
    ("POST", "/v1/what-if", {"point": [0.4, 0.6, 0.2], "radius": 0.05,
                             "n_perturb": 8, "seed": 3}),
    ("POST", "/v1/predict", {}),
    ("POST", "/v1/predict", {"points": [[1, 2]]}),
    ("POST", "/v1/what-if", {"point": [0.4, 0.6, 0.2], "radius": 2.0}),
    ("POST", "/v1/nope", {}),
    ("GET", "/nope", None),
    ("POST", "/v1/refresh", {}),
]


def test_gateways_answer_alike(tmp_path):
    root = str(tmp_path / "study")
    _archive(root, 0, 64, seed=0)
    ref = Snapshot_ref(root, n_members=2, hidden=16, steps=40)
    port = convert.snapshot_from_jax(
        [{k: np.asarray(v) for k, v in layer.items()}
         for layer in ref._sur.stacked], root,
        X=ref._X, y=ref._y, version=ref.version, cursor=ref._cursor,
        device="cpu", hidden=16, steps=40)
    assert (port.version, port.rows, port.dims) == (1, 64, 3)
    with Gateway_ref(ref, auth_token=None) as gw_ref, \
            SurrogateGateway(port, auth_token=None) as gw:
        for method, path, body in REQUESTS:
            st_ref, out_ref = _request(gw_ref.port, method, path, body)
            st, out = _request(gw.port, method, path, body)
            assert st == st_ref, (path, body)
            if st_ref == 200:
                _close(out, out_ref, path)
            else:
                assert sorted(out) == sorted(out_ref) == ["error"]
        # a new bundle: both refreshes fold the same 32 rows in
        _archive(root, 64, 96, seed=1)
        for gw_ in (gw_ref, gw):
            st, out = _request(gw_.port, "POST", "/v1/refresh", {})
            assert st == 200 and out == {"refreshed": True, "version": 2,
                                         "rows": 96}
        st, stats = _request(gw.port, "GET", "/v1/stats")
        st_ref, stats_ref = _request(gw_ref.port, "GET", "/v1/stats")
        assert st == st_ref == 200
        assert stats["http"] == stats_ref["http"]
        assert stats["snapshot"] == stats_ref["snapshot"]
