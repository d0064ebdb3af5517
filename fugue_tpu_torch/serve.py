"""JSON-RPC service for the DSL and the incremental sessions: the host
process's serving boundary.

The port of ``fugue_tpu/serve.py``. A web frontend (or any client) POSTs
``{"method": ..., "params": ...}`` and drives the real engines on the card.
Stdlib only (``http.server`` + ``json``).

``FugueService`` is transport-agnostic (dict in, dict out; testable without
sockets); ``serve()`` wraps it in a ``ThreadingHTTPServer``. Every result
is plain JSON (tensors and arrays become nested lists). The service runs
its models and sessions on ``device``, the card unless the caller names
another; nothing falls back to the CPU. Calls are serialized with one lock:
one card, device-resident session state. Each call runs in its handler
thread, whose grad mode is the default (enabled); the engines take their
gradients through ``torch.func`` and need no mode set elsewhere.

The methods and their params, defaults, result keys and error codes are
the JAX service's, with one difference: ``vi.run`` rejects
``n_iterations < 1`` and ``posterior_draws < 1`` with -32602.
``hmc.sharded`` runs ``parallel.sharded.sharded_hmc_chain`` over the
process's one-rank chain mesh (a group the service makes when there is
none); a service that is one of several ranks answers it with -32000,
since a request reaches only its own process. Replies that
summarize draws (``hmc.sharded``, ``vi.run``) compute the summaries on the
device and read them to the host once.

While a profiler session runs (``utils.profiling``), a request over HTTP is
a ``serve.request`` span (read, parse, ``handle``, JSON, write) holding
``serve.lock_wait`` (until the lock is held), ``serve.method`` (the
method, its name an attribute) and ``serve.reply`` (the result made JSON
values, under the lock), all with the request's id; ``handle`` called
without a transport gives its spans an id of their own.

Usage::

    python -m fugue_tpu_torch.serve --port 8700            # on the card
    python -m fugue_tpu_torch.serve --port 8700 --device cpu

    curl -d '{"method":"compile","params":{"source":"let p <- sample(\\"p\\", \\
        beta(2.0, 2.0)); observe(\\"y\\", bernoulli(p), 1); return p"}}' localhost:8700
"""

from __future__ import annotations

import json
import threading
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from .core.rng import fold_seed
from .utils import profiling


def _jsonable(x):
    if isinstance(x, dict):
        return {str(k): _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, torch.Tensor):
        profiling.host_read("serve.reply")
        return x.detach().cpu().tolist()  # one transfer per leaf; bool and bf16 too
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, (np.floating, np.integer, np.bool_)):
        return x.item()
    return x


def _split_rows(stats: Dict[str, Any], names) -> Dict[str, Dict[str, list]]:
    """``{address: (len(names), k) tensor}`` → ``{address: {name: [k
    floats]}}``, with ONE device-to-host read for all of them."""
    if stats:
        profiling.host_read("serve.summaries")
    host = torch.cat(list(stats.values()), dim=1).cpu().numpy() if stats else None
    out, off = {}, 0
    for addr, t in stats.items():
        k = t.shape[1]
        out[addr] = {name: host[i, off:off + k].tolist() for i, name in enumerate(names)}
        off += k
    return out


class ServiceError(Exception):
    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code


class FugueService:
    """Method registry + model/session stores. One instance per process;
    calls are serialized with a lock (one card, device-resident session
    state). ``seed`` is the default of every request's ``params.seed``."""

    def __init__(self, seed: int = 0, *, device="cuda"):
        self.device = torch.device(device)
        self._models: Dict[str, Any] = {}  # id -> (CompiledModel, model_fn, staged)
        self._sessions: Dict[str, Any] = {}
        self._next = 0
        self._seed = seed
        self._lock = threading.Lock()
        self.methods: Dict[str, Callable] = {
            "compile": self._compile,
            "mh.new": self._mh_new,
            "mh.step": self._mh_step,
            "mh.history": self._mh_history,
            "hmc.new": self._hmc_new,
            "hmc.step": self._hmc_step,
            "hmc.set": self._hmc_set,
            "pf.new": self._pf_new,
            "pf.observe": self._pf_observe,
            "smc.run": self._smc_run,
            "grid": self._grid,
            "nuts.new": self._nuts_new,
            "nuts.step": self._nuts_step,
            "nuts.set": self._nuts_set,
            "chees.new": self._chees_new,
            "chees.step": self._chees_step,
            "vi.run": self._vi_run,
            "hmc.sharded": self._hmc_sharded,
            "methods": lambda p: {"methods": sorted(self.methods)},
        }

    # -- plumbing -----------------------------------------------------------

    def handle(self, request: Dict[str, Any]) -> Dict[str, Any]:
        """One JSON-RPC call: {"method", "params"?, "id"?} →
        {"result"} | {"error": {"code", "message"}} (+ echoed id)."""
        rid = request.get("id")
        span_request = profiling.request_id()
        if span_request is None:  # no transport opened a serve.request span
            span_request = profiling.new_request_id()
        try:
            method = request.get("method")
            fn = self.methods.get(method)
            if fn is None:
                raise ServiceError(-32601, f"unknown method {method!r}")
            with profiling.span("serve.lock_wait", request=span_request):
                self._lock.acquire()
            try:
                with profiling.span("serve.method", request=span_request, method=method):
                    result = fn(request.get("params") or {})
                with profiling.span("serve.reply", request=span_request):
                    out = {"result": _jsonable(result)}
            finally:
                self._lock.release()
        except ServiceError as e:
            out = {"error": {"code": e.code, "message": str(e)}}
        except Exception as e:  # engine/typed errors surface as messages
            out = {"error": {"code": -32000,
                             "message": f"{type(e).__name__}: {e}"}}
        if rid is not None:
            out["id"] = rid
        return out

    def _new_id(self, prefix: str) -> str:
        self._next += 1
        return f"{prefix}-{self._next}"

    def _key(self, params, salt: int = 0) -> int:
        """The request's seed (``params.seed``, else the service's) folded
        with a per-method salt."""
        return fold_seed(int(params.get("seed", self._seed)), salt)

    def _model(self, params):
        mid = params.get("model_id")
        if mid not in self._models:
            raise ServiceError(-32602, f"unknown model_id {mid!r}")
        return self._models[mid]

    def _session(self, params, kind):
        sid = params.get("session_id")
        sess = self._sessions.get(sid)
        if sess is None or not isinstance(sess, kind):
            raise ServiceError(-32602, f"unknown session_id {sid!r}")
        return sess

    # -- methods ------------------------------------------------------------

    def _compile(self, p):
        from .dsl.compiler import compile_model
        from .runtime.staging import stage

        source = p.get("source")
        if not source:
            raise ServiceError(-32602, "params.source required")
        compiled = compile_model(source)
        model_fn = compiled.build(p.get("data"), device=self.device)
        staged = stage(model_fn, device=self.device)
        mid = self._new_id("model")
        self._models[mid] = (compiled, model_fn, staged)
        return {
            "model_id": mid,
            "dim": staged.dim,
            "sites": [
                {"address": s.address, "support": s.support.kind,
                 "shape": list(s.shape)}
                for s in staged.sites
            ],
            "observed": staged.observed_addresses,
            "warnings": compiled.take_warnings(),
        }

    def _mh_new(self, p):
        from .dsl.sessions import MhSession

        _, _, staged = self._model(p)
        sess = MhSession(
            self._key(p, 1),
            staged=staged,
            n_chains=int(p.get("n_chains", 4)),
            pinned_scale=p.get("pinned_scale"),
        )
        sid = self._new_id("mh")
        self._sessions[sid] = sess
        return {"session_id": sid, "n_chains": sess.n_chains}

    def _mh_step(self, p):
        from .dsl.sessions import MhSession

        sess = self._session(p, MhSession)
        values = sess.step(int(p.get("n", 1)))
        return {"values": values, "accept_rate": sess.accept_rate}

    def _mh_history(self, p):
        from .dsl.sessions import MhSession

        sess = self._session(p, MhSession)
        addr = p.get("address")
        if addr is None:
            raise ServiceError(-32602, "params.address required")
        return {"values": sess.chain_values(addr)}

    def _hmc_new(self, p):
        from .inference.hmc import HMCConfig, HmcSession

        _, _, staged = self._model(p)
        cfg = HMCConfig(
            step_size=p.get("step_size"),
            n_leapfrog=int(p.get("n_leapfrog", 32)),
        )
        sess = HmcSession(self._key(p, 2), staged=staged, config=cfg)
        sid = self._new_id("hmc")
        self._sessions[sid] = sess
        return {"session_id": sid, "step_size": sess.step_size,
                "n_leapfrog": sess.n_leapfrog, "dim": staged.dim}

    def _hmc_step(self, p):
        from .inference.hmc import HmcSession

        sess = self._session(p, HmcSession)
        if p.get("recorded"):
            return sess.step_recorded()
        info = sess.step()
        profiling.host_read("serve.hmc_step", 3)
        return {
            "accepted": bool(info.accepted),
            "divergent": bool(info.divergent),
            "accept_prob": float(info.accept_prob),
            "position": sess.position,
        }

    def _hmc_set(self, p):
        from .inference.hmc import HmcSession

        sess = self._session(p, HmcSession)
        if "step_size" in p:
            sess.set_step_size(float(p["step_size"]))
        if "n_leapfrog" in p:
            sess.set_n_leapfrog(int(p["n_leapfrog"]))
        return {"step_size": sess.step_size, "n_leapfrog": sess.n_leapfrog}

    def _pf_new(self, p):
        from .dsl.sessions import ParticleFilter

        sess = ParticleFilter(
            self._key(p, 3),
            n_particles=int(p.get("n_particles", 512)),
            process_sd=float(p.get("process_sd", 0.3)),
            obs_sd=float(p.get("obs_sd", 0.5)),
            device=self.device,
        )
        sid = self._new_id("pf")
        self._sessions[sid] = sess
        return {"session_id": sid}

    def _pf_observe(self, p):
        from .dsl.sessions import ParticleFilter

        sess = self._session(p, ParticleFilter)
        return sess.observe(float(p["y"]))

    def _smc_run(self, p):
        from .dsl.sessions import smc_run
        from .inference.smc import SMCConfig

        _, _, staged = self._model(p)
        cfg = SMCConfig(
            rejuvenation_steps=int(p.get("rejuvenation_steps", 3)),
        )
        return smc_run(
            self._key(p, 4), staged=staged,
            n_particles=int(p.get("n_particles", 512)), config=cfg,
        )

    def _nuts_new(self, p):
        from .inference.nuts import NUTSConfig, NutsSession

        _, _, staged = self._model(p)
        cfg = NUTSConfig(
            step_size=p.get("step_size"),
            max_depth=int(p.get("max_depth", 8)),
        )
        sess = NutsSession(self._key(p, 5), staged=staged, config=cfg)
        if p.get("warmup"):
            sess.warmup(int(p["warmup"]))
        sid = self._new_id("nuts")
        self._sessions[sid] = sess
        return {"session_id": sid, "step_size": sess.step_size,
                "max_depth": sess.max_depth, "dim": staged.dim}

    def _nuts_step(self, p):
        from .inference.nuts import NutsSession

        sess = self._session(p, NutsSession)
        if p.get("recorded"):
            return sess.step_recorded()
        return sess.step()

    def _nuts_set(self, p):
        from .inference.nuts import NutsSession

        sess = self._session(p, NutsSession)
        if "step_size" in p:
            sess.set_step_size(float(p["step_size"]))
        return {"step_size": sess.step_size}

    def _chees_new(self, p):
        from .inference.chees import ChEESConfig, CheesSession

        _, _, staged = self._model(p)
        cfg = ChEESConfig(criterion=p.get("criterion", "chees"))
        sess = CheesSession(
            self._key(p, 6), staged=staged, config=cfg,
            n_chains=int(p.get("n_chains", 64)),
            n_warmup=int(p.get("n_warmup", 300)),
        )
        sid = self._new_id("chees")
        self._sessions[sid] = sess
        return {"session_id": sid, "step_size": sess.step_size,
                "trajectory_length": sess.trajectory_length,
                "n_chains": sess.n_chains}

    def _chees_step(self, p):
        from .inference.chees import CheesSession

        sess = self._session(p, CheesSession)
        out = None
        for _ in range(max(1, int(p.get("n", 1)))):
            out = sess.step()
        return out

    def _vi_run(self, p):
        """One-shot variational inference on a compiled model, mean-field
        or full-rank ADVI. Returns per-site variational posterior summaries
        (mean/sd over constrained guide draws) plus the ELBO trace."""
        from .inference.vi import (VIConfig, optimize_fullrank_vi,
                                   optimize_meanfield_vi)

        _, _, staged = self._model(p)
        cfg = VIConfig(
            n_iterations=int(p.get("n_iterations", 1000)),
            n_samples=int(p.get("n_samples", 16)),
            learning_rate=float(p.get("learning_rate", 0.05)),
        )
        n_draws = int(p.get("posterior_draws", 1024))
        # the JAX service indexes an empty ELBO history at n_iterations=0
        # (IndexError) and averages zero draws (NaN): both are invalid params
        if cfg.n_iterations < 1:
            raise ServiceError(-32602, f"n_iterations must be >= 1, got {cfg.n_iterations}")
        if n_draws < 1:
            raise ServiceError(-32602, f"posterior_draws must be >= 1, got {n_draws}")
        guide_kind = p.get("guide", "meanfield")
        if guide_kind not in ("meanfield", "fullrank"):
            raise ServiceError(
                -32602, f"guide must be 'meanfield' or 'fullrank', "
                        f"got {guide_kind!r}")
        optimize = (optimize_fullrank_vi if guide_kind == "fullrank"
                    else optimize_meanfield_vi)
        res = optimize(self._key(p, 8), staged=staged, config=cfg)
        draws = res.posterior_sample(self._key(p, 9), n_draws)
        flats = {addr: vals.detach().to(torch.float64).reshape(vals.shape[0], -1)
                 for addr, vals in draws.items()}
        posterior = _split_rows(
            {addr: torch.stack([f.mean(dim=0), f.std(dim=0, unbiased=False)])
             for addr, f in flats.items()}, ("mean", "sd"))
        hist = np.asarray(res.elbo_history, np.float64)
        # downsample for the wire but always keep the final point
        stride = max(1, len(hist) // 200)
        idx = np.unique(np.r_[np.arange(0, len(hist), stride),
                              len(hist) - 1])
        return {
            "guide": guide_kind,
            "converged": bool(res.converged),
            "n_iterations_run": int(res.n_iterations_run),
            "final_elbo": float(hist[-1]),
            "elbo_history": hist[idx].tolist(),
            "posterior": posterior,
        }

    def _hmc_sharded(self, p):
        """One-shot HMC through the sharded driver over the process's
        one-rank chain mesh: ``sharded_hmc_chain`` with ``n_chains``
        (default 8), and per continuous site the posterior mean,
        sd and split-R-hat of each element, computed on the device and read
        back once. A process that is one of several ranks answers -32000."""
        import torch.distributed as dist

        from .inference.mcmc_utils import split_r_hat
        from .parallel.distributed import config_from_env
        from .parallel.mesh import make_chain_mesh
        from .parallel.sharded import sharded_hmc_chain

        _, _, staged = self._model(p)
        # a request reaches one process; the other ranks would never join
        # its collectives
        if (dist.get_world_size() if dist.is_initialized()
                else config_from_env().num_processes or 1) > 1:
            raise ServiceError(-32000, "hmc.sharded runs at one rank: the other ranks of "
                                       "this process group do not receive the request")
        mesh = make_chain_mesh(device=self.device)
        n_chains = int(p.get("n_chains", 8))
        res = sharded_hmc_chain(
            self._key(p, 7), staged=staged,
            n_samples=int(p.get("n_samples", 500)),
            n_warmup=int(p.get("n_warmup", 500)),
            n_chains=n_chains, mesh=mesh,
        )
        rows = {}
        for s in staged.continuous_sites:
            vals = res.samples[s.address].to(torch.float64)
            flat = vals.reshape(vals.shape[0], vals.shape[1], -1)
            rows[s.address] = torch.stack([
                flat.mean(dim=(0, 1)), flat.std(dim=(0, 1), unbiased=False),
                split_r_hat(flat.movedim(2, 0))])
        return {
            "n_devices": mesh.size(),
            "n_chains": n_chains,
            "step_size": res.step_size,
            "summaries": _split_rows(rows, ("mean", "sd", "r_hat")),
        }

    def _grid(self, p):
        from .dsl.sessions import log_joint_grid

        _, _, staged = self._model(p)
        return log_joint_grid(
            None,
            p["x_address"], p["y_address"],
            tuple(p["x_range"]), tuple(p["y_range"]),
            int(p.get("resolution", 64)),
            staged=staged,
            fixed=p.get("fixed"),
        )


def serve(port: int = 8700, host: str = "127.0.0.1",
          service: Optional[FugueService] = None, *, block: bool = True,
          device="cuda"):
    """Serve ``FugueService`` over HTTP (POST JSON to any path). Without a
    ``service``, a new one runs on ``device``. With ``block=False`` the
    server is returned unstarted: run its ``serve_forever`` in a thread and
    stop it with ``shutdown()``."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    svc = service or FugueService(device=device)

    class Handler(BaseHTTPRequestHandler):
        def do_POST(self):  # noqa: N802 (stdlib API)
            with profiling.span("serve.request", request=profiling.new_request_id()):
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n) or b"{}")
                    out = svc.handle(req)
                except json.JSONDecodeError as e:
                    out = {"error": {"code": -32700, "message": f"parse: {e}"}}
                body = json.dumps(out).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Access-Control-Allow-Origin", "*")
                self.end_headers()
                self.wfile.write(body)

        def log_message(self, *a):  # quiet
            pass

    httpd = ThreadingHTTPServer((host, port), Handler)
    if block:
        httpd.serve_forever()
    return httpd


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--port", type=int, default=8700)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--device", default="cuda",
                    help="device of the models and sessions (default: cuda)")
    args = ap.parse_args(argv)
    print(f"fugue-tpu-torch JSON-RPC service on {args.host}:{args.port} ({args.device})")
    serve(args.port, args.host, device=args.device)


if __name__ == "__main__":
    main()
