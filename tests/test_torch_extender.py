"""The port's HTTP extender host loop (tpusim_torch.sim.extender) against a
stub extender on 127.0.0.1, as tests/test_extender.py drives tpusim's:
filter subsetting, prioritize steering, nodeCacheCapable payloads, the
failure policy, the managedResources gate, each with the same placements
as tpusim's loop against the same stub; a pass-through extender equal to
the port's sequential oracle; the config parsing; and `apply` with an
extender scheduler config equal to `python -m tpusim apply`'s output."""

import contextlib
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np
import pytest
import yaml

import tests.test_torch_types_trace  # noqa: F401 (one torch thread)
from tests.test_torch_apply import _apply_both
from tests.test_torch_types_trace import REPO
from tpusim.io.trace import NodeRow as JNodeRow
from tpusim.io.trace import PodRow as JPodRow
from tpusim.sim.driver import Simulator as JSimulator
from tpusim.sim.driver import SimulatorConfig as JConfig
from tpusim.sim.extender import ExtenderConfig as JExtenderConfig
from tpusim.sim.typical import TypicalPodsConfig as JTypicalCfg
from tpusim_torch.config.scheduler import (
    SchedulerConfigError,
    parse_scheduler_config,
)
from tpusim_torch.io.trace import NodeRow, PodRow
from tpusim_torch.sim.driver import Simulator, SimulatorConfig
from tpusim_torch.sim.extender import ExtenderConfig
from tpusim_torch.sim.typical import TypicalPodsConfig


class _StubExtender(BaseHTTPRequestHandler):
    """Scriptable extender: class attributes set its behaviour."""

    reject_nodes = set()  # names the filter drops
    favorite = None  # prioritize: this node gets score 10, the others 0
    fail_filter = False
    calls = []

    def do_POST(self):
        body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        type(self).calls.append((self.path, body))
        if self.path.endswith("/filter"):
            if type(self).fail_filter:
                self.send_response(500)
                self.end_headers()
                return
            names = body.get("nodenames")
            if names is None:
                names = [it["metadata"]["name"]
                         for it in body["nodes"]["items"]]
            keep = [n for n in names if n not in type(self).reject_nodes]
            resp = ({"nodenames": keep} if body.get("nodenames") is not None
                    else {"nodes": {"items": [
                        {"metadata": {"name": n}} for n in keep]}})
        else:  # prioritize
            names = body.get("nodenames") or [
                it["metadata"]["name"] for it in body["nodes"]["items"]]
            resp = [{"host": n, "score": 10 if n == type(self).favorite
                     else 0} for n in names]
        data = json.dumps(resp).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, *a):
        pass


@contextlib.contextmanager
def stub_extender():
    """The stub served on 127.0.0.1 (loopback only) for the block: yields
    its URL."""
    httpd = HTTPServer(("127.0.0.1", 0), _StubExtender)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    _StubExtender.reject_nodes = set()
    _StubExtender.favorite = None
    _StubExtender.fail_filter = False
    _StubExtender.calls = []
    try:
        yield f"http://127.0.0.1:{httpd.server_port}"
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)


@pytest.fixture
def extender_server():
    with stub_extender() as url:
        yield url


@pytest.fixture(autouse=True)
def _no_bellman_cache(monkeypatch):
    monkeypatch.setenv("TPUSIM_BELLMAN_CACHE", "")


def _cluster(node_row):
    # two identical nodes: without extender input, node-0 wins every tie
    return [node_row("node-0", 32000, 131072, 4, "V100M16"),
            node_row("node-1", 32000, 131072, 4, "V100M16")]


def _pods(pod_row, n=4):
    return [pod_row(f"p{i}", 4000, 4096, 1, 500) for i in range(n)]


def _run_both(url, n_pods=4, pods=None, report=True, **ext_kw):
    """tpusim's and the port's Simulator.run() with one extender at `url`
    (BestFit, seed 0): the port's sim and result; tpusim's placements must
    equal them."""
    ext = dict(url_prefix=url, filter_verb="filter",
               prioritize_verb="prioritize")
    ext.update(ext_kw)
    out = []
    for sim_cls, cfg_cls, ext_cls, tcfg, node_row, pod_row, kw in (
            (JSimulator, JConfig, JExtenderConfig, JTypicalCfg, JNodeRow,
             JPodRow, {}),
            (Simulator, SimulatorConfig, ExtenderConfig, TypicalPodsConfig,
             NodeRow, PodRow, {"device": "cpu"})):
        cfg = cfg_cls(
            policies=(("BestFitScore", 1000),), gpu_sel_method="best", seed=0,
            report_per_event=report,
            typical_pods=tcfg(pod_popularity_threshold=95),
            extenders=(ext_cls(**ext),))
        sim = sim_cls(_cluster(node_row), cfg, **kw)
        sim.set_workload_pods(pods(pod_row) if pods else _pods(pod_row,
                                                                n_pods))
        out.append((sim, sim.run()))
    (jsim, jres), (psim, pres) = out
    assert jsim._last_engine == psim.last_engine == "extender"
    np.testing.assert_array_equal(pres.placed_node,
                                  np.asarray(jres.placed_node))
    np.testing.assert_array_equal(pres.dev_mask, np.asarray(jres.dev_mask))
    assert [u.pod.name for u in pres.unscheduled_pods] == \
        [u.pod.name for u in jres.unscheduled_pods]
    return psim, pres


def test_extender_filter_excludes_node(extender_server):
    """A filter-rejected node never receives a pod, though the plugin
    scores prefer it."""
    _StubExtender.reject_nodes = {"node-0"}
    _, res = _run_both(extender_server)
    assert set(res.placed_node.tolist()) == {1}
    verbs = {p.rsplit("/", 1)[-1] for p, _ in _StubExtender.calls}
    assert verbs == {"filter", "prioritize"}


def test_extender_prioritize_steers_selection(extender_server):
    """The top extender priority (10) x weight x the 100/10 scale beats the
    plugin-score gap between two near-equal nodes."""
    _StubExtender.favorite = "node-1"
    _, res = _run_both(extender_server, weight=100)
    assert set(res.placed_node.tolist()) == {1}


def test_extender_noop_matches_sequential_oracle(extender_server):
    """With a pass-through extender the host loop reproduces the port's
    sequential oracle (the same step functions, the same key chain): the
    placements, the masks and the report log."""
    sim, res = _run_both(extender_server)
    plain = SimulatorConfig(
        policies=(("BestFitScore", 1000),), gpu_sel_method="best", seed=0,
        report_per_event=True, engine="sequential",
        typical_pods=TypicalPodsConfig(pod_popularity_threshold=95))
    sim2 = Simulator(_cluster(NodeRow), plain, device="cpu")
    sim2.set_workload_pods(_pods(PodRow))
    res2 = sim2.run()
    np.testing.assert_array_equal(res.placed_node, res2.placed_node)
    np.testing.assert_array_equal(res.dev_mask, res2.dev_mask)
    assert [x for x in sim.log.lines if "[Engine]" not in x] == \
        [x for x in sim2.log.lines if "[Engine]" not in x]


def test_extender_nodecache_capable_payloads(extender_server):
    """nodeCacheCapable sends and receives NodeNames only."""
    _StubExtender.reject_nodes = {"node-0"}
    _, res = _run_both(extender_server, node_cache_capable=True)
    assert set(res.placed_node.tolist()) == {1}
    for _, body in _StubExtender.calls:
        assert "nodenames" in body and "nodes" not in body


def test_extender_failure_policy(extender_server, monkeypatch):
    """A failing filter fails the cycle (the pods unschedulable) unless the
    extender is ignorable (findNodesThatPassExtenders)."""
    monkeypatch.setenv("TPUSIM_HTTP_RETRIES", "1")  # no backoff sleeps
    _StubExtender.fail_filter = True
    _, res = _run_both(extender_server, n_pods=2)
    assert len(res.unscheduled_pods) == 2
    assert (res.placed_node == -1).all()
    _StubExtender.calls = []
    _, res = _run_both(extender_server, n_pods=2, ignorable=True)
    assert not res.unscheduled_pods


def test_extender_managed_resources_gate(extender_server):
    """managedResources restricts the extender to pods requesting one of
    them (IsInterested): a CPU-only pod skips the GPU-managed extender."""
    _StubExtender.reject_nodes = {"node-0", "node-1"}  # would fail any pod
    _, res = _run_both(
        extender_server, report=False, prioritize_verb="",
        managed_resources=("alibabacloud.com/gpu-milli",),
        pods=lambda row: [row("cpu-pod", 4000, 4096, 0, 0),
                          row("gpu-pod", 4000, 4096, 1, 500)])
    assert {u.pod.name for u in res.unscheduled_pods} == {"gpu-pod"}
    assert res.placed_node[0] >= 0


def test_extender_config_parsing():
    """The extenders entry parses into the loop's ExtenderConfig; bindVerb
    and enableHTTPS over http are refused."""
    doc = {
        "apiVersion": "kubescheduler.config.k8s.io/v1beta1",
        "kind": "KubeSchedulerConfiguration",
        "extenders": [{
            "urlPrefix": "http://ext:8080/scheduler",
            "filterVerb": "filter", "prioritizeVerb": "prioritize",
            "weight": 5, "nodeCacheCapable": True,
            "managedResources": [{"name": "alibabacloud.com/gpu-milli",
                                  "ignoredByScheduler": True}],
        }],
        "profiles": [{"schedulerName": "simon-scheduler", "plugins": {
            "score": {"enabled": [{"name": "FGDScore", "weight": 1000}]}}}],
    }
    (ext,) = parse_scheduler_config(doc).extenders
    assert isinstance(ext, ExtenderConfig)
    assert ext.url_prefix == "http://ext:8080/scheduler"
    assert ext.weight == 5 and ext.node_cache_capable
    assert ext.managed_resources == ("alibabacloud.com/gpu-milli",)
    doc["extenders"][0]["bindVerb"] = "bind"
    with pytest.raises(SchedulerConfigError, match="bindVerb"):
        parse_scheduler_config(doc)
    del doc["extenders"][0]["bindVerb"]
    doc["extenders"][0]["enableHTTPS"] = True
    with pytest.raises(SchedulerConfigError, match="enableHTTPS"):
        parse_scheduler_config(doc)


def extender_scheduler_config(path, url: str) -> str:
    """The example scheduler config (FGD) with an extender at `url` that
    filters and prioritizes; written to `path`."""
    with open(os.path.join(REPO, "example",
                           "test-scheduler-config.yaml")) as f:
        doc = yaml.safe_load(f)
    doc["extenders"] = [{"urlPrefix": url, "filterVerb": "filter",
                         "prioritizeVerb": "prioritize", "weight": 3}]
    path.write_text(yaml.safe_dump(doc))
    return str(path)


def test_apply_with_extenders_matches_jax(tmp_path, extender_server):
    """`apply` on the example bundle with a scheduler config whose
    extender rejects a node and favours another: the port's standard
    output equals `python -m tpusim apply`'s, but for [Engine] lines."""
    sc = extender_scheduler_config(tmp_path / "sc.yaml", extender_server)
    with open(os.path.join(REPO, "example", "test-cluster", "node",
                           "gpu-node-a.yaml")) as f:
        _StubExtender.reject_nodes = {yaml.safe_load(f)["metadata"]["name"]}
    port, jax = _apply_both(["-f", os.path.join(
        REPO, "example", "test-cluster-config.yaml"), "-s", sc, "-e", "gpu",
        "--report", "--base-dir", REPO])
    assert port == jax
    assert "Cluster Analysis" in port and _StubExtender.calls
