"""The port's HTTP front (``repro_torch.launch.serve_http``) on a local
port, mirroring ``tests/test_serve_http.py``: submit, drain and
``GET /stats`` over a live service on the CPU; protocol errors as HTTP 200
``{"ok": false}``; transport errors as 400, 404 and 405.  The service
behind it is held to JAX's in ``tests/test_torch_service.py``; here the
same submit through both packages' ``handle_request`` gives the same
answer."""
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import init_carry_multi as j_init_carry_multi
from repro.core import init_matcher as j_init_matcher
from repro.core import init_state as j_init_state
from repro.launch.serve_search import handle_request as j_handle_request
from repro.serve.service import SearchService as JSearchService
from repro.sim import RepoSpec as JSpec
from repro.sim import generate as j_generate
from repro.sim.oracle import class_select as j_class_select
from repro.sim.oracle import oracle_detect as j_detect
from repro_torch.core import SearchPlan, init_carry, init_carry_multi, init_matcher, init_state, prng
from repro_torch.launch.serve_http import make_server
from repro_torch.launch.serve_search import handle_request
from repro_torch.serve.service import SearchService
from repro_torch.sim import RepoSpec, class_select, filter_class, generate, oracle_detect

CPU = "cpu"
WORLD = dict(video_lengths=[5_000] * 3, num_instances=100, chunk_frames=500, locality=4.0, seed=7)
SERVICE = dict(cohorts=2, num_workers=1, slots_per_batch=2)


def _service(device=CPU):
    repo, chunks = generate(RepoSpec(**WORLD), device=device)
    proto = init_carry_multi(init_state(chunks.length, device=device), init_matcher(max_results=64, device=device),
                             torch.stack([prng.PRNGKey(0, device=device)]))
    service = SearchService(proto, chunks, lambda key, frame: oracle_detect(repo, frame, query_class=None),
                            select=class_select(repo, [0, 1]), cache_frames=chunks.total_frames, **SERVICE)
    service.repo, service.chunks = repo, chunks
    return service


@pytest.fixture(scope="module")
def front():
    service = _service()
    server = make_server(service, port=0)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    service.start(pump=False)
    yield service, f"http://127.0.0.1:{port}"
    server.shutdown()
    server.server_close()
    service.stop()
    thread.join(timeout=5.0)


def _post(base, obj, raw=None, method="POST"):
    req = urllib.request.Request(base, data=raw if raw is not None else json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"}, method=method)
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read().decode())


def _get(base, path=""):
    with urllib.request.urlopen(base + path, timeout=30) as resp:
        return json.loads(resp.read().decode())


def test_http_submit_drain_stats(front):
    service, base = front
    resp = _post(base, {"op": "submit", "tenant": "t-http", "class": 0, "seed": 1,
                        "plan": {"result_limit": 6, "max_steps": 1500, "cohorts": 2,
                                 "execution": {"queries_axis": True}}})
    assert resp["ok"] is True and resp["state"] == "running", resp
    resp = _post(base, {"op": "drain"})
    assert resp["ok"] is True
    tenant = resp["tenants"]["t-http"]
    assert tenant["state"] == "finished"
    assert tenant["detector_invocations"] > 0
    # the reference's 6 is its own exact-Gamma trajectory; the port's is its
    # solo scan's under the port's exact Gamma, to the same limit
    row = service.tenants["t-http"].row_obj
    repo = service.repo
    carry = init_carry(init_state(service.chunks.length, device=CPU), init_matcher(max_results=64, device=CPU),
                       prng.PRNGKey(1, device=CPU))
    solo = SearchPlan(result_limit=6, max_steps=row.budget, cohorts=2, method="exact").run(
        carry, service.chunks, detector=lambda k, f: filter_class(repo, oracle_detect(repo, f, query_class=None), 0))
    assert (tenant["results"], tenant["steps"]) == (solo.results[0], solo.steps[0])
    assert tenant["results"] >= 6
    stats = _get(base, "/stats")
    assert stats["ok"] is True
    assert stats["tenants"]["t-http"]["state"] == "finished"


def test_http_protocol_error_is_200_ok_false(front):
    _, base = front
    resp = _post(base, {"op": "frobnicate"})
    assert resp["ok"] is False and "unknown op" in resp["error"]
    resp = _post(base, {"op": "submit", "tenant": "bad",
                        "plan": {"result_limit": 5, "queries": 3, "execution": {"queries_axis": True}}})
    assert resp["ok"] is False and resp.get("field") == "queries"


def test_http_transport_errors(front):
    _, base = front
    for raw, code in ((b"{not json", 400), (b'["a", "list"]', 400)):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base, None, raw=raw)
        assert e.value.code == code
        assert json.loads(e.value.read().decode())["ok"] is False
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(base, "/nope")
    assert e.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base, {"op": "stats"}, method="PUT")
    assert e.value.code == 405
    assert json.loads(e.value.read().decode())["ok"] is False


def test_handle_request_answers_as_jax():
    """The same requests through both packages' ``handle_request``, over
    services with ``"wilson_hilferty"`` drivers driven to the end: the
    same answers less the clock fields."""
    jrepo, jchunks = j_generate(JSpec(**WORLD))
    jproto = j_init_carry_multi(j_init_state(jchunks.length), j_init_matcher(max_results=64),
                                jnp.stack([jax.random.PRNGKey(0)]))
    jservice = JSearchService(jproto, jchunks, lambda key, frame: j_detect(jrepo, frame, query_class=None),
                              select=j_class_select(jrepo, [0, 1]), cache_frames=jchunks.total_frames, **SERVICE)
    tservice = _service()
    tservice.driver.method = jservice.driver.method = "wilson_hilferty"
    requests = [
        {"op": "submit", "tenant": "a", "class": 0, "seed": 1,
         "plan": {"result_limit": 4, "max_steps": 600, "cohorts": 2, "execution": {"queries_axis": True}}},
        {"op": "submit", "tenant": "b", "class": 1, "seed": 2,
         "plan": {"result_limit": 4, "max_steps": 600, "cohorts": 2, "execution": {"queries_axis": True}}},
        {"op": "submit", "tenant": "a", "plan": {"result_limit": 4}},
        {"op": "submit", "tenant": "c", "plan": {"max_step": 5}},
        {"op": "nope"},
    ]
    clock = ("ttfr_s", "slo_met")

    def answers(service, handle):
        out = [handle(service, r) for r in requests]
        while service.busy():
            service.driver._issue_ready()
            while not service.driver._work.empty():
                batch = service.driver._work.get_nowait()
                service.driver._merge(service.driver._process_batch(0, batch))
            service._reap()
            service._admit_queued()
        out.append(handle(service, {"op": "drain"}))
        return json.loads(json.dumps(out))

    def less_clock(x):
        if isinstance(x, dict):
            return {k: less_clock(v) for k, v in x.items() if k not in clock}
        if isinstance(x, list):
            return [less_clock(v) for v in x]
        return x

    tout, jout = answers(tservice, handle_request), answers(jservice, j_handle_request)
    assert less_clock(tout) == less_clock(jout)
    assert tout[-1]["tenants"]["a"]["state"] == "finished" and tout[-1]["tenants"]["a"]["results"] >= 1
