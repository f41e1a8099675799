"""The port's kube-client loader (tpusim_torch.io.kube_client) against
tpusim's (tpusim.io.kube_client) over the same recorded API fixture: the
local HTTP server of tests/test_kube_client.py replaying canned list
responses. Both loaders must give equal cluster objects, route the same
files, fall back, retry and fail alike; the port's Applier must run a
kubeconfig credential file through its loader, with the same standard
output as tpusim's."""

import dataclasses
import io

import pytest
import yaml

import tpusim.io.kube_client as jkc
import tpusim_torch.io.kube_client as pkc
# api_server and flaky_server are fixtures
from tests.test_kube_client import (  # noqa: F401
    _FLAKY,
    _TOKEN_PLUGIN,
    FORBIDDEN,
    _exec_kubeconfig,
    _Handler,
    _kubeconfig,
    _no_sleep,
    api_server,
    flaky_server,
)

LOADERS = pytest.mark.parametrize("kc", [jkc, pkc], ids=["tpusim", "port"])


def _plain(x):
    """A parsed object as plain data, whichever package's class it is."""
    if dataclasses.is_dataclass(x):
        return {f.name: _plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    return x


def _cluster(c):
    return {name: _plain(getattr(c, name))
            for name in ("nodes", "pods", "daemonsets", "other")}


def test_loaders_give_equal_clusters(tmp_path, api_server):
    kc = _kubeconfig(tmp_path, api_server)
    want = jkc.load_cluster_from_client(kc)
    got = pkc.load_cluster_from_client(kc)
    assert _cluster(got) == _cluster(want)
    assert [n.name for n in got.nodes] == ["node-a", "node-b"]
    assert [p.name for p in got.workload_pods()] == \
        [p.name for p in want.workload_pods()]
    assert len(got.pods) == 4  # the static pod, 2 replicas, the solo RS


def test_exec_plugin_clusters_equal(tmp_path, api_server):
    """The exec credential plugin path: the same bearer token on the
    wire, the same cluster."""
    kc = _exec_kubeconfig(tmp_path, api_server, _TOKEN_PLUGIN)
    seen = []
    orig = _Handler.do_GET

    def spy(self):
        seen.append(self.headers.get("Authorization"))
        return orig(self)

    _Handler.do_GET = spy
    try:
        want = jkc.load_cluster_from_client(kc)
        got = pkc.load_cluster_from_client(kc)
    finally:
        _Handler.do_GET = orig
    assert set(seen) == {"Bearer exec-minted-from-env"}
    assert _cluster(got) == _cluster(want)


def test_routing_agrees(tmp_path, api_server):
    kc = _kubeconfig(tmp_path, api_server)
    dump = tmp_path / "dump.yaml"
    dump.write_text(yaml.dump({"kind": "List", "items": []}))
    junk = tmp_path / "junk.bin"
    junk.write_bytes(b"\xff\xfe\x00binary")
    for path in (kc, str(dump), str(junk), str(tmp_path / "missing")):
        assert pkc.is_kubeconfig_file(path) == jkc.is_kubeconfig_file(path)
    assert pkc.is_kubeconfig_file(kc)


@LOADERS
def test_forbidden_fallback_and_denial(kc, tmp_path, api_server):
    """A 403 on the deprecated group-version falls through to the current
    one; every candidate denied raises."""
    path = _kubeconfig(tmp_path, api_server)
    FORBIDDEN.add("/apis/policy/v1beta1/poddisruptionbudgets")
    try:
        assert [n.name for n in kc.load_cluster_from_client(path).nodes] \
            == ["node-a", "node-b"]
        FORBIDDEN.add("/apis/policy/v1/poddisruptionbudgets")
        with pytest.raises(kc.KubeClientError, match="PodDisruptionBudget"):
            kc.load_cluster_from_client(path)
    finally:
        FORBIDDEN.clear()


@LOADERS
def test_unreachable_and_auth_provider(kc, tmp_path):
    with pytest.raises(kc.KubeClientError, match="cannot reach"):
        kc.load_cluster_from_client(_kubeconfig(tmp_path,
                                                "http://127.0.0.1:1"))
    p = tmp_path / "legacy"
    p.write_text(yaml.dump({
        "apiVersion": "v1", "kind": "Config", "current-context": "c",
        "clusters": [{"name": "c", "cluster": {"server": "http://x"}}],
        "users": [{"name": "u", "user": {"exec": {
            "command": "gke-gcloud-auth-plugin"}}}],
        "contexts": [{"name": "c", "context": {"cluster": "c",
                                               "user": "u"}}]}))
    with pytest.raises(kc.KubeClientError, match="credential plugin"):
        kc.KubeClient(str(p))


@LOADERS
def test_retries(kc, tmp_path, flaky_server, monkeypatch):
    """Two 503s are absorbed; a Retry-After is honoured; 404 is an answer,
    never retried."""
    slept = _no_sleep(monkeypatch)
    _FLAKY.update(failures_left=2, status=503)
    client = kc.KubeClient(_kubeconfig(tmp_path, flaky_server))
    assert client.get("/api/v1/nodes") == {"apiVersion": "v1", "items": []}
    assert _FLAKY["hits"] == 3 and len(slept) == 2
    _FLAKY.update(failures_left=1, status=429, retry_after=3, hits=0)
    assert client.get("/api/v1/nodes")["items"] == []
    assert slept[2:] == [3.0]
    _FLAKY.update(failures_left=1, status=404, retry_after=None, hits=0)
    with pytest.raises(FileNotFoundError):
        client.get("/api/v1/nodes")
    assert _FLAKY["hits"] == 1


def test_port_applier_routes_kubeconfig_to_client(tmp_path, api_server):
    """spec.cluster.kubeConfig naming a kubeconfig credential file: the
    port's Applier lists the live cluster through its loader (it no longer
    refuses), and prints what tpusim's Applier prints but for the [Engine]
    lines."""
    from tpusim.apply import Applier as JApplier
    from tpusim.apply import ApplyOptions as JOptions
    from tpusim_torch.apply import Applier, ApplyOptions

    kc = _kubeconfig(tmp_path, api_server)
    cc = tmp_path / "cc.yaml"
    cc.write_text(yaml.dump({
        "apiVersion": "simon/v1alpha1", "kind": "Config",
        "metadata": {"name": "live"},
        "spec": {"cluster": {"kubeConfig": kc}}}))
    outs = []
    for applier in (
            JApplier(JOptions(simon_config=str(cc),
                              extended_resources=["gpu"])),
            Applier(ApplyOptions(simon_config=str(cc),
                                 extended_resources=["gpu"],
                                 device="cpu"))):
        out = io.StringIO()
        applier.run(out=out)
        outs.append([line for line in out.getvalue().splitlines()
                     if "[Engine]" not in line])
    assert outs[1] == outs[0]
    assert any("unscheduled pods" in line for line in outs[1])
