"""The PyTorch port's JSON-RPC service (``fugue_tpu_torch/serve.py``) on the
CPU: every case of the JAX package's ``tests/test_serve.py``, on
``FugueService(device="cpu")`` at reduced iterations, float64; plus the
same ``compile`` result and error codes as the JAX service for the same
requests, the registered methods (the JAX service's), the browser client's
calls and one HTTP round trip. ``hmc.sharded`` (the multi-device engine)
runs over a one-rank process group here (``tests/test_torch_parallel.py``
checks its reply).

Intended divergence (ROADMAP §C): ``vi.run`` with ``n_iterations=0`` or
``posterior_draws=0`` is a -32602 validation error; the JAX service raises
``IndexError`` at ``hist[-1]`` (-32000) and returns NaN moments.
"""

import html as html_mod
import json
import os
import re
import threading
import urllib.request

import numpy as np
import pytest

import fugue_tpu.serve as jserve
from fugue_tpu_torch import settings
from fugue_tpu_torch.serve import FugueService, serve

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COIN = (
    'let p <- sample("p", beta(2.0, 2.0));'
    'for i in 0..10 { observe(("y", i), bernoulli(p), flips[i]); }'
    'return p;'
)
FLIPS = [1, 1, 1, 0, 1, 1, 0, 1, 0, 1]
NORMAL3 = ('let mu <- sample("mu", normal(0.0, 2.0));'
           'for i in 0..3 { observe(("y", i), normal(mu, 1.0), ys[i]); }'
           'return mu;')


@pytest.fixture(autouse=True)
def _x64():
    settings.enable_x64(True)
    yield
    settings.enable_x64(False)


@pytest.fixture()
def svc():
    return FugueService(seed=0, device="cpu")


def _call(svc, method, **params):
    out = svc.handle({"method": method, "params": params, "id": 1})
    assert "error" not in out, out
    assert out["id"] == 1
    return out["result"]


def _compile_coin(svc):
    res = _call(svc, "compile", source=COIN, data={"flips": FLIPS})
    assert res["dim"] == 1
    assert res["sites"][0]["address"] == "p"
    assert len(res["observed"]) == 10
    assert res["warnings"] == []
    return res["model_id"]


def _compile_normal3(svc):
    return _call(svc, "compile", source=NORMAL3, data={"ys": [1.0, 1.2, 0.8]})["model_id"]


def test_service_defaults_to_the_card():
    assert FugueService().device.type == "cuda"


def test_compile_and_mh_session(svc):
    mid = _compile_coin(svc)
    sid = _call(svc, "mh.new", model_id=mid, n_chains=8)["session_id"]
    for _ in range(40):
        out = _call(svc, "mh.step", session_id=sid, n=10)
    # posterior Beta(9, 5): mean 9/14
    hist = np.asarray(_call(svc, "mh.history", session_id=sid, address="p")["values"])
    assert hist.shape == (400, 8)
    assert hist[200:].mean() == pytest.approx(9 / 14, abs=0.05)
    assert 0.0 < out["accept_rate"] <= 1.0
    np.testing.assert_array_equal(out["values"]["p"], hist[-1])


def test_hmc_session_with_trajectory(svc):
    mid = _compile_coin(svc)
    new = _call(svc, "hmc.new", model_id=mid, n_leapfrog=8)
    sid = new["session_id"]
    assert new["step_size"] > 0
    rec = _call(svc, "hmc.step", session_id=sid, recorded=True)
    assert len(rec["trajectory"]) == 8
    assert len(rec["hamiltonians"]) == 8
    out = _call(svc, "hmc.set", session_id=sid, n_leapfrog=4)
    assert out["n_leapfrog"] == 4
    rec = _call(svc, "hmc.step", session_id=sid, recorded=True)
    assert len(rec["trajectory"]) == 4
    step = _call(svc, "hmc.step", session_id=sid)
    assert set(step) == {"accepted", "divergent", "accept_prob", "position"}
    assert isinstance(step["accepted"], bool) and len(step["position"]) == 1


def test_smc_run_and_grid(svc):
    mid = _compile_coin(svc)
    res = _call(svc, "smc.run", model_id=mid, n_particles=1024)
    assert np.isfinite(res["log_evidence"])
    assert res["posterior_means"]["p"] == pytest.approx(9 / 14, abs=0.04)

    src = ('let mu <- sample("mu", normal(0.0, 2.0));'
           'let tau <- sample("tau", normal(0.0, 2.0)); return mu;')
    mid2 = _call(svc, "compile", source=src)["model_id"]
    g = _call(svc, "grid", model_id=mid2, x_address="mu", y_address="tau",
              x_range=[-2, 2], y_range=[-2, 2], resolution=16)
    z = np.asarray(g["log_joint"])
    assert z.shape == (16, 16)
    assert np.isfinite(z).all()


def test_pf_session(svc):
    sid = _call(svc, "pf.new", n_particles=256)["session_id"]
    est = None
    for y in (0.1, 0.3, 0.2, 0.4):
        est = _call(svc, "pf.observe", session_id=sid, y=y)
    assert set(est) == {"mean", "var", "ess"}
    assert abs(est["mean"] - 0.3) < 0.5
    assert est["ess"] > 10


def test_nuts_session_rpc(svc):
    mid = _compile_normal3(svc)
    s = _call(svc, "nuts.new", model_id=mid, warmup=30)
    sid = s["session_id"]
    assert s["step_size"] > 0 and s["max_depth"] == 8 and s["dim"] == 1
    out = _call(svc, "nuts.step", session_id=sid, recorded=True)
    assert out["n_leapfrog"] == len(out["trajectory"])
    assert all(np.isfinite(h) for h in out["hamiltonians"])
    assert _call(svc, "nuts.set", session_id=sid, step_size=0.3)["step_size"] == 0.3
    # a short run concentrates on the conjugate posterior mean 3.0/3.25
    vals = [_call(svc, "nuts.step", session_id=sid)["position"][0] for _ in range(200)]
    assert abs(float(np.mean(vals[50:])) - 3.0 / 3.25) < 0.25


def test_chees_session_rpc(svc):
    mid = _compile_normal3(svc)
    s = _call(svc, "chees.new", model_id=mid, n_chains=32, n_warmup=150)
    assert s["trajectory_length"] > 0 and s["n_chains"] == 32
    out = _call(svc, "chees.step", session_id=s["session_id"], n=40)
    assert len(out["positions"]) == 32
    # after 40 frozen-kernel steps the cloud sits on the posterior
    cloud = np.asarray(out["positions"]).ravel()
    assert abs(cloud.mean() - 3.0 / 3.25) < 0.3


def test_vi_run_rpc(svc):
    """The coin model's posterior is Beta(9, 5) (mean 9/14 ≈ 0.643, sd ≈
    0.124); the mean-field Beta family and full-rank ADVI recover both."""
    mid = _compile_coin(svc)
    out = _call(svc, "vi.run", model_id=mid, n_iterations=400, posterior_draws=4096)
    post = out["posterior"]["p"]
    assert post["mean"][0] == pytest.approx(9 / 14, abs=0.04)
    assert post["sd"][0] == pytest.approx(0.1237, abs=0.04)
    assert out["n_iterations_run"] >= 1
    assert len(out["elbo_history"]) >= 2
    assert out["final_elbo"] == pytest.approx(out["elbo_history"][-1])
    assert out["guide"] == "meanfield"

    fr = _call(svc, "vi.run", model_id=mid, guide="fullrank", n_iterations=400,
               posterior_draws=4096)
    assert fr["posterior"]["p"]["mean"][0] == pytest.approx(9 / 14, abs=0.05)

    err = svc.handle({"method": "vi.run", "params": {"model_id": mid, "guide": "laplace"}})
    assert err["error"]["code"] == -32602


@pytest.mark.parametrize("params", [{"n_iterations": 0}, {"posterior_draws": 0},
                                    {"n_iterations": -3}])
def test_vi_run_rejects_empty_runs(svc, params):
    """The repair of the JAX service's IndexError / NaN (an intended
    divergence)."""
    mid = _compile_coin(svc)
    err = svc.handle({"method": "vi.run", "params": {"model_id": mid, **params}, "id": 4})
    assert err["error"]["code"] == -32602 and err["id"] == 4


def test_compile_matches_the_jax_service(svc):
    req = {"method": "compile", "id": 3, "params": {
        "source": COIN.replace("return p;", 'let q <- sample("q", normal(0.0, 1.0));'
                                            'factor(nope); return p;'),
        "data": {"flips": FLIPS}}}
    ours, theirs = svc.handle(req), jserve.FugueService(seed=0).handle(req)
    assert ours == theirs  # model id, dim, sites, observed and the soft warning
    assert len(ours["result"]["warnings"]) == 1 and ours["result"]["dim"] == 2


ERROR_REQUESTS = [
    {"method": "nope"},
    {"method": "hmc.sharded", "params": {"model_id": "model-9"}},
    {"method": "mh.step", "params": {"session_id": "x"}},
    {"method": "mh.history", "params": {"session_id": "x", "address": "p"}},
    {"method": "compile", "params": {}},
    {"method": "compile", "params": {"source": "observe("}},
    {"method": "mh.new", "params": {"model_id": "model-9"}},
    {"method": "pf.observe", "params": {"session_id": "pf-0", "y": 1.0}},
    {"method": "vi.run", "params": {"model_id": "model-1", "guide": "laplace"}},
    {"method": "grid", "params": {"model_id": "model-1"}},
]


@pytest.mark.parametrize("req", ERROR_REQUESTS, ids=lambda r: r["method"])
def test_error_codes_match_the_jax_service(svc, req):
    """The same error code as the JAX service for the same request."""
    jsvc = jserve.FugueService(seed=0)
    for s in (svc, jsvc):
        s.handle({"method": "compile", "params": {"source": COIN, "data": {"flips": FLIPS}}})
    ours = svc.handle(req)
    theirs = jsvc.handle(req)
    assert ours["error"]["code"] == theirs["error"]["code"]
    assert ours["error"]["message"].split(":")[0] == theirs["error"]["message"].split(":")[0]


def test_soft_errors_surface_as_warnings(svc):
    res = _call(svc, "compile", source='let x <- sample("x", normal(0.0, 1.0)); return nope;')
    assert res["model_id"] and res["warnings"]


def test_methods_are_the_jax_services_but_the_sharded_engine(svc):
    ours = set(_call(svc, "methods")["methods"])
    assert ours == set(jserve.FugueService().methods)  # hmc.sharded included
    assert ours == set(svc.methods)


def test_js_client_methods_match_service(svc):
    """docs/explorables/fugue_client.js calls only registered methods (the
    sharded engine too), and every registered method but ``methods``."""
    js = open(os.path.join(REPO, "docs", "explorables", "fugue_client.js")).read()
    called = set(re.findall(r'this\.rpc\(\s*"([^"]+)"', js))
    registered = set(svc.methods)
    assert called - registered == set()
    assert registered - called <= {"methods"}


def test_live_explorable_source_compiles(svc):
    page = open(os.path.join(REPO, "docs", "explorables", "live.html")).read()
    m = re.search(r'<pre id="src">(.*?)</pre>', page, re.S)
    assert m, "live.html must embed its model source in <pre id='src'>"
    source = html_mod.unescape(m.group(1))
    data_m = re.search(r"const DATA = (\{[^;]*\});", page)
    assert data_m
    data = json.loads(re.sub(r"(\w+):", r'"\1":', data_m.group(1)))
    out = svc.handle({"method": "compile", "params": {"source": source, "data": data}})
    assert "result" in out, out
    assert out["result"]["dim"] == 1


def test_http_round_trip():
    """Compile, then an MH session stepped from the server's handler
    threads, and a bad body."""
    httpd = serve(port=0, service=FugueService(device="cpu"), block=False)
    port = httpd.server_address[1]
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()

    def post(body: bytes):
        req = urllib.request.Request(f"http://127.0.0.1:{port}/", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as resp:
            return json.loads(resp.read())

    try:
        out = post(json.dumps({"method": "compile", "id": 7, "params": {
            "source": COIN, "data": {"flips": [1, 0, 1, 1]}}}).encode())
        assert out["id"] == 7 and out["result"]["dim"] == 1
        mid = out["result"]["model_id"]
        sid = post(json.dumps({"method": "mh.new", "params": {
            "model_id": mid, "n_chains": 4}}).encode())["result"]["session_id"]
        step = post(json.dumps({"method": "mh.step", "params": {
            "session_id": sid, "n": 5}}).encode())["result"]
        assert len(step["values"]["p"]) == 4
        assert post(b"{not json")["error"]["code"] == -32700
    finally:
        httpd.shutdown()
        httpd.server_close()
    t.join(timeout=10)
    assert not t.is_alive()
