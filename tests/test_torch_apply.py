"""The port's apply entry against `python -m tpusim apply`, at tolerance 0:
the k8s manifest and config parsing, the Helm renderer, the app queues,
the data-prep converters, the standard output and snapshot files of
`python -m tpusim_torch.cli apply --device cpu` on the three example
bundles and on a bundle with apps, a chart, inflation, the new-workload
swap, the snapshot exports, a kubeConfig dump and a MaxCPU cap; every
option the port refuses; `python -m tpusim_torch --workload-inflation-ratio`
against experiments/run.py; and, slow-marked, the openb apply and the
digests chip_smoke.py holds the card to."""

import contextlib
import dataclasses
import filecmp
import hashlib
import io
import os

import pytest
import yaml

import chip_smoke
import tests.test_torch_types_trace  # noqa: F401 (one torch thread)
from tests.test_torch_report import _cut, run_args, run_experiment
from tests.test_torch_types_trace import REPO
from tpusim import apply as japply
from tpusim import cli as jcli
from tpusim.config import scheduler as jsched
from tpusim.config import simon as jsimon
from tpusim.io import chart as jchart
from tpusim.io import data_prep as jprep
from tpusim.io import export as jexport
from tpusim.io import storage as jstorage
from tpusim.io import k8s_yaml as jk8s
from tpusim.io.trace import NodeRow as JNodeRow
from tpusim.io.trace import PodRow as JPodRow
from tpusim.sim import queues as jqueues
from tpusim_torch import apply as papply
from tpusim_torch import cli as pcli
from tpusim_torch.__main__ import main as port_main
from tpusim_torch.config import scheduler as psched
from tpusim_torch.config import simon as psimon
from tpusim_torch.io import chart as pchart
from tpusim_torch.io import data_prep as pprep
from tpusim_torch.io import export as pexport
from tpusim_torch.io import storage as pstorage
from tpusim_torch.io import k8s_yaml as pk8s
from tpusim_torch.io.trace import NodeRow as PNodeRow
from tpusim_torch.io.trace import PodRow as PPodRow
from tpusim_torch.sim import queues as pqueues

EXAMPLES = ("example", "example/new1", "example/new2")


@pytest.fixture(autouse=True)
def _no_bellman_cache(monkeypatch):
    """The JAX package would keep its Bellman series on disk."""
    monkeypatch.setenv("TPUSIM_BELLMAN_CACHE", "")


def _same(port, jax):
    """Port and JAX dataclasses (or lists of them) hold equal fields."""
    if isinstance(jax, (list, tuple)):
        assert len(port) == len(jax)
        for a, b in zip(port, jax):
            _same(a, b)
        return
    if dataclasses.is_dataclass(jax):
        assert type(port).__name__ == type(jax).__name__
        for f in dataclasses.fields(jax):
            _same(getattr(port, f.name), getattr(jax, f.name))
        return
    assert port == jax


def _clusters_same(p, j):
    _same(p.nodes, j.nodes)
    _same(p.pods, j.pods)
    assert p.daemonsets == j.daemonsets and p.other == j.other
    _same(p.daemonset_pods(), j.daemonset_pods())


# ---- manifests, configs, charts, queues, data prep ----


def test_quantities_match_jax():
    for q in ("4", "250m", 64, "1.5", "", None):
        assert pk8s.parse_cpu_milli(q) == jk8s.parse_cpu_milli(q)
    for q in ("256000Mi", "2Gi", "1048576Ki", str(512 * 1024 * 1024), "1G",
              "3Ti", "", None):
        assert pk8s.parse_mem_mib(q) == jk8s.parse_mem_mib(q)


@pytest.mark.parametrize("bundle", EXAMPLES)
def test_example_cluster_dirs_match_jax(bundle):
    """Each example bundle's cluster directory parses to the same nodes,
    pods and daemonsets; its CR and scheduler config to the same
    settings."""
    d = os.path.join(REPO, bundle)
    cr = psimon.load_simon_cr(os.path.join(d, "test-cluster-config.yaml"),
                              REPO)
    _same(cr, jsimon.load_simon_cr(
        os.path.join(d, "test-cluster-config.yaml"), REPO))
    _clusters_same(pk8s.load_cluster_from_dir(cr.custom_cluster),
                   jk8s.load_cluster_from_dir(cr.custom_cluster))
    sc = os.path.join(d, "test-scheduler-config.yaml")
    p, j = psched.load_scheduler_config(sc), jsched.load_scheduler_config(sc)
    _same(p, j)
    assert p.policy_tuple() == j.policy_tuple()
    _same(psched.load_scheduler_config(""), jsched.load_scheduler_config(""))


def _workload_objects():
    """tests/test_config_cli.py's workload fixtures, plus a StatefulSet, a
    CronJob, a ReplicaSet owned by a Deployment and a static pod."""
    deploy = {"kind": "Deployment", "metadata": {"name": "web",
                                                 "namespace": "d"},
              "spec": {"replicas": 3, "template": {"spec": {"containers": [
                  {"resources": {"requests": {"cpu": "1",
                                              "memory": "1Gi"}}}]}}}}
    job = {"kind": "Job", "metadata": {"name": "batch"},
           "spec": {"completions": 2, "template": {
               "metadata": {"annotations": {
                   "alibabacloud.com/gpu-count": "1",
                   "alibabacloud.com/gpu-milli": "300"}},
               "spec": {"containers": [
                   {"resources": {"requests": {"cpu": "500m"}}}]}}}}
    node = {"kind": "Node", "metadata": {"name": "n0"},
            "status": {"allocatable": {"cpu": "8", "memory": "16Gi"}}}
    ds = {"kind": "DaemonSet", "metadata": {"name": "agent"},
          "spec": {"template": {"spec": {"containers": [
              {"resources": {"requests": {"cpu": "100m"}}}]}}}}
    sts = {"kind": "StatefulSet", "metadata": {"name": "db"},
           "spec": {"replicas": 2, "template": {"spec": {
               "nodeSelector": {"disk": "ssd"},
               "tolerations": [{"key": "x"}],
               "containers": [{"resources": {"limits": {"cpu": "2"}}}]}}}}
    cron = {"kind": "CronJob", "metadata": {"name": "nightly"},
            "spec": {"jobTemplate": {"spec": {"template": {"spec": {
                "containers": [{"resources": {"requests": {
                    "cpu": "1"}}}]}}}}}}
    rs = {"kind": "ReplicaSet", "metadata": {
        "name": "web-abc", "ownerReferences": [{"kind": "Deployment"}]},
        "spec": {"replicas": 1}}
    static = {"kind": "Pod", "metadata": {
        "name": "etcd", "annotations": {"kubernetes.io/config.mirror": "x"}},
        "spec": {"nodeName": "n0", "containers": [
            {"resources": {"requests": {"cpu": "250m"}}}]}}
    svc = {"kind": "Service", "metadata": {"name": "s"}}
    return [deploy, job, node, ds, sts, cron, rs, static, svc]


def test_workload_expansion_and_dump_match_jax(tmp_path):
    objs = _workload_objects()
    _clusters_same(pk8s.load_cluster_from_objects(objs),
                   jk8s.load_cluster_from_objects(objs))
    dump = tmp_path / "dump.yaml"
    dump.write_text(yaml.safe_dump({"kind": "List", "items": objs}))
    _clusters_same(pk8s.load_cluster_from_dump(str(dump)),
                   jk8s.load_cluster_from_dump(str(dump)))


def _config_docs():
    base = {"apiVersion": "kubescheduler.config.k8s.io/v1beta1",
            "kind": "KubeSchedulerConfiguration"}
    score = {"disabled": [{"name": n} for n in (
        "RandomScore", "FGDScore", "ImageLocality", "NodeAffinity")],
        "enabled": [{"name": "FGDScore", "weight": 1000},
                    {"name": "PWRScore", "weight": 500}]}
    return [
        {**base, "profiles": [{"schedulerName": "simon-scheduler",
                               "plugins": {"score": score},
                               "pluginConfig": [{"name": "Open-Gpu-Share",
                                                 "args": {"gpuSelMethod":
                                                          "FGDScore"}}]}]},
        {**base, "profiles": [{"plugins": {"score": {"enabled": [
            {"name": "NotAPlugin"}]}}}]},
        {**base, "percentageOfNodesToScore": 50},
        {**base, "percentageOfNodesToScore": "most"},
        {**base, "percentageOfNodesToScore": 100},
        {**base, "extenders": [{"urlPrefix": "http://x/"}]},
        {**base, "extenders": [{"urlPrefix": "http://x/",
                                "prioritizeVerb": "p", "weight": 0}]},
        {**base, "extenders": [{"urlPrefix": "http://x/",
                                "filterVerb": "f", "weight": 0,
                                "httpTimeout": "1m30s"}]},
        {**base, "profiles": [{"pluginConfig": [{"args": {
            "normMethod": "bad"}}]}]},
    ]


def _outcome(fn, path):
    try:
        return "ok", fn(path)
    except Exception as err:  # the error's type and message must agree
        return "error", (type(err).__name__, str(err))


@pytest.mark.parametrize("i", range(len(_config_docs())))
def test_scheduler_configs_match_jax(tmp_path, i):
    """tests/test_config_cli.py's scheduler-config cases: the same
    settings, or the same error."""
    path = tmp_path / "sc.yaml"
    path.write_text(yaml.dump(_config_docs()[i]))
    (pk, pv), (jk, jv) = (_outcome(psched.load_scheduler_config, str(path)),
                          _outcome(jsched.load_scheduler_config, str(path)))
    assert pk == jk
    if pk == "ok":
        assert [dataclasses.asdict(e) for e in pv.extenders] == \
            [dataclasses.asdict(e) for e in jv.extenders]
        _same(dataclasses.replace(pv, extenders=()),
              dataclasses.replace(jv, extenders=()))
    else:
        assert pv == jv


def test_simon_crs_match_jax(tmp_path):
    """The CR cases of tests/test_config_cli.py, the CR knobs the apply
    path reads, and the lenient tab handling of the reference's own
    example configs."""
    docs = [
        {"apiVersion": "simon/v1alpha1", "kind": "Config",
         "spec": {"cluster": {"customConfig": "example/test-cluster"},
                  "customConfig": {"engine": "table"}}},
        {"apiVersion": "simon/v1alpha1", "kind": "Config",
         "spec": {"cluster": {}}},
        {"apiVersion": "simon/v1alpha1", "kind": "Config",
         "metadata": {"name": "x"},
         "spec": {"cluster": {"kubeConfig": "dump.yaml"},
                  "appList": [{"name": "a", "path": "apps/a"},
                              {"name": "c", "path": "/abs/c", "chart": True}],
                  "customConfig": {
                      "shufflePod": True, "useTimestamps": True, "mesh": 2,
                      "exportConfig": {"podSnapshotYamlFilePrefix": "o/p",
                                       "nodeSnapshotCSVFilePrefix": "o/n"},
                      "workloadInflationConfig": {"ratio": 1.5, "seed": 7},
                      "workloadTuningConfig": {"ratio": 1.3, "seed": 42},
                      "newWorkloadConfig": "nw",
                      "descheduleConfig": {"ratio": 0.1,
                                           "policy": "fragOnePod"},
                      "typicalPodsConfig": {"isInvolvedCpuPods": False,
                                            "podPopularityThreshold": 80,
                                            "podIncreaseStep": 5,
                                            "gpuResWeight": 0.5}}}},
    ]
    for i, doc in enumerate(docs):
        path = tmp_path / f"cr{i}.yaml"
        path.write_text(yaml.dump(doc))
        (pk, pv), (jk, jv) = (
            _outcome(lambda p: psimon.load_simon_cr(p, REPO), str(path)),
            _outcome(lambda p: jsimon.load_simon_cr(p, REPO), str(path)))
        assert pk == jk
        if pk == "ok":
            _same(pv, jv)
        else:
            assert pv == jv
    tabbed = tmp_path / "tabbed.yaml"
    tabbed.write_text("apiVersion: simon/v1alpha1\nkind: Config\nspec:\n"
                      "  cluster:\n    customConfig: c\t# a tab comment\n"
                      "  customConfig:\n    shufflePod: 'a\tb'\n")
    _same(psimon.load_simon_cr(str(tabbed)), jsimon.load_simon_cr(str(tabbed)))


def _chart_fixtures(root):
    """The charts of tests/test_config_cli.py (test_chart_render,
    test_chart_render_full_engine, test_chart_tpl_and_semver) and the
    chip_smoke.py apply phase's chart: {name: directory}."""
    charts = {}

    def write(name, files):
        d = root / name
        for rel, text in files.items():
            (d / rel).parent.mkdir(parents=True, exist_ok=True)
            (d / rel).write_text(text)
        charts[name] = str(d)

    write("mychart", {
        "Chart.yaml": "name: mychart\nversion: 1.0.0\n",
        "values.yaml": "replicas: 2\ncpu: 500m\n",
        "templates/deploy.yaml": (
            "kind: Deployment\nmetadata:\n  name: {{ .Release.Name }}-web\n"
            "spec:\n  replicas: {{ .Values.replicas }}\n  template:\n"
            "    spec:\n      containers:\n      - resources:\n"
            "          requests:\n            cpu: {{ .Values.cpu | quote }}\n"),
    })
    write("web", {
        "Chart.yaml": "name: web\nversion: 0.1.0\nappVersion: '2.4'\n",
        "values.yaml": (
            'nameOverride: ""\nreplicaCount: 3\nautoscaling:\n'
            '  enabled: false\nimage:\n  repository: nginx\n  tag: ""\n'
            "resources:\n  requests:\n    cpu: 250m\n    memory: 64Mi\n"
            "nodeSelector:\n  disktype: ssd\nservice:\n  enabled: true\n"
            "  ports: [80, 443]\n"),
        "templates/_helpers.tpl": (
            "{{/* boilerplate comment */}}\n"
            '{{- define "web.name" -}}\n'
            "{{- default .Chart.Name .Values.nameOverride | trunc 63 | "
            'trimSuffix "-" -}}\n{{- end -}}\n'
            '{{- define "web.fullname" -}}\n'
            '{{- printf "%s-%s" .Release.Name (include "web.name" .) | '
            'trunc 63 | trimSuffix "-" -}}\n{{- end -}}\n'
            '{{- define "web.labels" -}}\napp: {{ include "web.name" . }}\n'
            "release: {{ .Release.Name }}\n{{- end -}}\n"),
        "templates/deployment.yaml": (
            "apiVersion: apps/v1\nkind: Deployment\nmetadata:\n"
            '  name: {{ include "web.fullname" . }}\n  labels:\n'
            '    {{- include "web.labels" . | nindent 4 }}\nspec:\n'
            "  {{- if not .Values.autoscaling.enabled }}\n"
            "  replicas: {{ .Values.replicaCount }}\n  {{- end }}\n"
            "  template:\n    spec:\n      containers:\n"
            "        - name: {{ .Chart.Name }}\n"
            '          image: "{{ .Values.image.repository }}:{{ '
            '.Values.image.tag | default .Chart.AppVersion }}"\n'
            "          resources:\n"
            "            {{- toYaml .Values.resources | nindent 12 }}\n"
            "      {{- with .Values.nodeSelector }}\n      nodeSelector:\n"
            "        {{- toYaml . | nindent 8 }}\n      {{- end }}\n"),
        "templates/service.yaml": (
            "{{- if .Values.service.enabled }}\napiVersion: v1\n"
            "kind: Service\nmetadata:\n"
            '  name: {{ include "web.fullname" . }}\nspec:\n  ports:\n'
            "    {{- range $i, $port := .Values.service.ports }}\n"
            '    - name: {{ printf "port-%d" $i | quote }}\n'
            "      port: {{ $port }}\n    {{- end }}\n{{- end }}\n"),
        "templates/NOTES.txt": 'Visit {{ include "web.fullname" . }}!\n',
    })
    write("t", {
        "Chart.yaml": "name: t\nversion: 1.0.0\n",
        "values.yaml": 'greeting: "hi {{ .Release.Name }}"\n',
        "templates/cm.yaml": (
            "kind: ConfigMap\nmetadata:\n  name: cm\ndata:\n"
            "  msg: {{ tpl .Values.greeting . | quote }}\n"
            '  new: {{ if semverCompare ">=1.19" '
            '.Capabilities.KubeVersion.Version }}"yes"{{ else }}"no"'
            "{{ end }}\n"),
    })
    write("infer", chip_smoke.APPLY_CHART)
    write("bad", {"Chart.yaml": "name: bad\nversion: 1.0.0\n",
                  "templates/loop.yaml": '{{ lookup "v1" "Pod" "ns" "x" }}\n'})
    return charts


def test_charts_match_jax(tmp_path):
    """chart_objects and render_chart on the chart fixtures: the same
    documents, or the same error."""
    for name, path in _chart_fixtures(tmp_path).items():
        for fn in ("chart_objects", "render_chart"):
            (pk, pv), (jk, jv) = (
                _outcome(lambda p: getattr(pchart, fn)("rel", p), path),
                _outcome(lambda p: getattr(jchart, fn)("rel", p), path))
            assert (pk, pv) == (jk, jv), (name, fn)


@pytest.mark.parametrize("use_greed", [False, True])
def test_app_queue_matches_jax(use_greed):
    """app_queue's order (greed, affinity, toleration) on pods of every
    kind, pinned, selected and tolerating ones among them."""
    rows = [("small", 100, 100), ("big", 8000, 64000), ("pinned", 500, 100),
            ("sel", 500, 100), ("tol", 500, 100), ("both", 2000, 100),
            ("mem", 100, 200000), ("tie", 500, 100)]
    extra = {"pinned": dict(pinned_node="n1"),
             "sel": dict(node_selector={"disk": "ssd"}),
             "tol": dict(tolerations=True),
             "both": dict(node_selector={"a": "b"}, tolerations=True)}

    def build(row_cls, node_cls):
        pods = [row_cls(n, c, m, 0, 0, **extra.get(n, {}))
                for n, c, m in rows]
        nodes = [node_cls("n0", 32000, 262144, 0),
                 node_cls("n1", 64000, 131072, 8, "A100")]
        return pods, nodes

    got = pqueues.app_queue(*build(PPodRow, PNodeRow), use_greed)
    want = jqueues.app_queue(*build(JPodRow, JNodeRow), use_greed)
    assert [p.name for p in got] == [p.name for p in want]


def test_prepare_input_matches_jax(tmp_path, capsys):
    """prepare_input on a cut of the openb CSVs (the node list and two pod
    traces): every file it writes, byte for byte, and the same printout."""
    csv = tmp_path / "csv"
    csv.mkdir()
    for name, rows in (("openb_node_list_gpu_node.csv", 31),
                       ("openb_pod_list_default.csv", 61),
                       ("openb_pod_list_gpushare20.csv", 41)):
        with open(os.path.join(REPO, "data/csv", name)) as f:
            (csv / name).write_text("".join(next(f) for _ in range(rows)))
    made = pprep.prepare_input(csv, tmp_path / "port")
    port_out = capsys.readouterr().out
    jmade = jprep.prepare_input(csv, tmp_path / "jax")
    assert capsys.readouterr().out == port_out.replace(
        str(tmp_path / "port"), str(tmp_path / "jax"))
    assert [p.name for p in made] == [p.name for p in jmade]
    cmp = filecmp.dircmp(tmp_path / "port", tmp_path / "jax")
    assert not cmp.left_only and not cmp.right_only
    for sub in cmp.common_dirs:
        files = os.listdir(tmp_path / "port" / sub)
        match, mismatch, errors = filecmp.cmpfiles(
            tmp_path / "port" / sub, tmp_path / "jax" / sub, files,
            shallow=False)
        assert len(match) == 2 and not mismatch and not errors


# ---- the apply entry end to end ----


def _apply_both(port_argv, jax_argv=None):
    """Standard output of the port's `apply --device cpu PORT_ARGV` and of
    `python -m tpusim apply JAX_ARGV` (the same flags by default), each
    without its [Engine] lines."""
    outs = []
    for main, applier, argv in (
            (pcli.main, papply.Applier, [*port_argv, "--device", "cpu"]),
            (jcli.main, japply.Applier, jax_argv or port_argv)):
        buf = io.StringIO()
        # the JAX package's Applier.run writes to the stdout it saw at
        # import; hand it this buffer instead
        run = applier.run
        applier.run = lambda self, out=None, _run=run: _run(self, out=buf)
        try:
            with contextlib.redirect_stdout(buf):
                assert main(["apply", *argv]) == 0
        finally:
            applier.run = run
        outs.append("".join(line for line in
                            buf.getvalue().splitlines(keepends=True)
                            if "[Engine]" not in line))
    return outs


@pytest.mark.parametrize("bundle", EXAMPLES)
def test_example_bundles_match_jax(bundle):
    """apply -e gpu --report on each example bundle: the same standard
    output, but for the [Engine] lines."""
    d = os.path.join(REPO, bundle)
    argv = ["-f", os.path.join(d, "test-cluster-config.yaml"),
            "-s", os.path.join(d, "test-scheduler-config.yaml"),
            "-e", "gpu", "--report", "--base-dir", REPO]
    port, jax = _apply_both(argv)
    assert "Cluster Analysis" in port and "Pod Info" in port
    assert port == jax


@pytest.mark.parametrize("bundle", EXAMPLES)
def test_default_profile_matches_jax(bundle):
    """apply without a scheduler config runs the built-in profile (Simon,
    BestFit, Random, DotProduct, FGD and PWR at weight 1): the same
    standard output, but for the [Engine] lines; the quickstart bundle's
    digest is the one chip_smoke.py holds the card to."""
    argv = ["-f", os.path.join(REPO, bundle, "test-cluster-config.yaml"),
            "--base-dir", REPO]
    port, jax = _apply_both(argv)
    assert "Cluster Analysis" in port
    assert port == jax
    if bundle == "example":
        assert hashlib.sha256(port.encode()).hexdigest() == \
            chip_smoke.APPLY_DEFAULT_SHA256


NODE_TMPL = """apiVersion: v1
kind: Node
metadata:
  name: {name}
  labels:
    kubernetes.io/hostname: {name}
    alibabacloud.com/gpu-card-model: {model}
    alibabacloud.com/cpu-model: Intel-Xeon-8163
status:
  allocatable:
    cpu: "{cpu}"
    memory: {mem}Mi
    alibabacloud.com/gpu-count: "{gpu}"
"""
POD_TMPL = """apiVersion: v1
kind: Pod
metadata:
  name: {name}
  namespace: trace
  annotations:
    alibabacloud.com/gpu-milli: "{milli}"
    alibabacloud.com/gpu-count: "{num}"
    alibabacloud.com/creation-time: "{ct}"
spec:
  containers:
  - name: main
    resources:
      requests:
        cpu: {cpu}m
        memory: {mem}Mi
"""


def _small_cluster(d, num_nodes=8, num_pods=40, seed=0, ds=True):
    """A heterogeneous YAML cluster: GPU nodes of three models and a
    CPU-only node, seeded pods (share, whole and CPU-only), a DaemonSet, a
    Deployment, an unscheduled-annotated pod and one node's open-local
    storage file."""
    import numpy as np

    rng = np.random.default_rng(seed)
    (d / "node").mkdir(parents=True)
    (d / "pod").mkdir()
    models = ["V100M16", "T4", "A100", ""]
    for i in range(num_nodes):
        m = models[i % 4]
        (d / "node" / f"n{i}.yaml").write_text(NODE_TMPL.format(
            name=f"node-{i:02d}", model=m or "none",
            cpu=int(rng.choice([32, 64, 96])), mem=int(rng.choice(
                [131072, 262144])), gpu=int(rng.choice([2, 4, 8])) if m
            else 0))
    docs = []
    for i in range(num_pods):
        kind = rng.integers(0, 3)
        milli = int(rng.choice([100, 250, 500, 750])) if kind == 1 else 1000
        num = 0 if kind == 0 else (1 if kind == 1 else int(
            rng.choice([1, 2, 4])))
        docs.append(POD_TMPL.format(
            name=f"p{i:03d}", milli=milli if num else 0, num=num,
            ct=1000 + int(rng.integers(0, 500)),
            cpu=int(rng.choice([1000, 2000, 4000, 8000])),
            mem=int(rng.choice([1024, 4096]))))
    (d / "pod" / "pods.yaml").write_text("---\n".join(docs))
    extra = [
        {"apiVersion": "apps/v1", "kind": "Deployment",
         "metadata": {"name": "svc", "namespace": "trace"},
         "spec": {"replicas": 3, "template": {"metadata": {"annotations": {
             "alibabacloud.com/gpu-milli": "300",
             "alibabacloud.com/gpu-count": "1"}}, "spec": {"containers": [
                 {"resources": {"requests": {"cpu": "1",
                                             "memory": "2Gi"}}}]}}}},
        {"apiVersion": "v1", "kind": "Pod",
         "metadata": {"name": "gone", "annotations": {
             "simon/pod-unscheduled": "true"}},
         "spec": {"containers": [{"resources": {"requests": {
             "cpu": "1"}}}]}},
    ]
    if ds:
        extra.append({"apiVersion": "apps/v1", "kind": "DaemonSet",
                      "metadata": {"name": "logger"},
                      "spec": {"template": {"spec": {"containers": [
                          {"resources": {"requests": {"cpu": "200m"}}}]}}}})
    (d / "pod" / "workloads.yaml").write_text(yaml.safe_dump_all(extra))
    (d / "node-01.json").write_text(
        '{"vgs": [{"name": "yoda-pool0", "capacity": 107374182400, '
        '"requested": 53687091200}], "devices": [{"device": "/dev/vdd", '
        '"capacity": 107374182400, "mediaType": "hdd", '
        '"isAllocated": false}]}')
    return str(d)


def _bundle(tmp_path, side, **kw):
    """write_apply_bundle over the small cluster for one side ("port" or
    "jax"), with a new-workload directory; returns (CR, export dir)."""
    root = tmp_path / side
    cluster = _small_cluster(tmp_path / "cluster", num_pods=16) if not (
        tmp_path / "cluster").exists() else str(tmp_path / "cluster")
    nw = tmp_path / "newload"
    if not nw.exists():
        _small_cluster(nw, num_nodes=0, num_pods=12, seed=5, ds=False)
    cr = chip_smoke.write_apply_bundle(
        str(root), cluster, "node-03", tune=kw.pop("tune", 1.2),
        inflation=kw.pop("inflation", 1.5),
        extra={"newWorkloadConfig": str(nw), **kw.pop("extra", {})}, **kw)
    return cr, os.path.join(str(root), "out")


def _exports(out_dir):
    return {name: hashlib.sha256(open(os.path.join(out_dir, name),
                                      "rb").read()).hexdigest()
            for name in sorted(os.listdir(out_dir))}


SCHEDULERS = {
    "fgd": os.path.join(REPO, "example", "test-scheduler-config.yaml"),
    "pwr": os.path.join(REPO, "example", "new1", "test-scheduler-config.yaml"),
    # no scheduler config: the built-in profile, which draws per event, so
    # every stage (main, inflation, the swap, each app) has its root key
    "default": None,
}


@pytest.mark.parametrize("sched", list(SCHEDULERS))
def test_full_bundle_matches_jax(tmp_path, sched):
    """A bundle with the YAML app and the Helm chart of chip_smoke.py, the
    new-workload swap, inflation 1.5, tuning 1.2 and the snapshot exports,
    under FGD, PWR and the built-in profile: the same standard output (the
    per-event blocks of every stage, the failed pods, each Cluster
    Analysis, the verdict and the report tables with open-local) and the
    same exported files."""
    cr_p, out_p = _bundle(tmp_path, "port")
    cr_j, out_j = _bundle(tmp_path, "jax")
    common = ["-e", "gpu,open-local", "--report"]
    if SCHEDULERS[sched]:
        common += ["-s", SCHEDULERS[sched]]
    port, jax = _apply_both(["-f", cr_p, *common], ["-f", cr_j, *common])
    for stage in ("Scheduling app yaml-app", "Scheduling app infer",
                  "(Inflation) Num of Total Pods", "Node Local Storage"):
        assert stage in port
    assert port == jax
    assert _exports(out_p) == _exports(out_j)
    assert len(_exports(out_p)) == 3
    # the snapshot resumes: read back and injected as the reference does
    snap = os.path.join(out_p, "pod_init_schedule.yaml")
    got, want = pexport.load_pod_yaml(snap), jexport.load_pod_yaml(snap)
    _same(got, want)
    _same(pexport.inject_snapshot_workload(got, 3),
          jexport.inject_snapshot_workload(want, 3))


def test_open_local_storage_matches_jax():
    """The open-local parsers on node and pod storage annotations (JSON
    strings and dicts, malformed JSON, unsupported volume kinds), the
    synthesised PVCs and the VG totals."""
    node = ('{"vgs": [{"name": "pool0", "capacity": 100, "requested": 40},'
            ' {"name": "pool1", "capacity": "60"}], "devices": [{"device":'
            ' "/dev/vdb", "capacity": 10, "mediaType": "ssd", "isAllocated":'
            ' true}]}')
    pod = ('{"volumes": [{"size": "20", "kind": "LVM", "scName":'
           ' "open-local-lvm"}, {"size": 5, "kind": "HDD"}, {"size": 1,'
           ' "kind": "NFS"}]}')
    for raw in (node, "{not json", None, {"vgs": []}):
        assert pstorage.maybe_json(raw) == jstorage.maybe_json(raw)
    _same(pstorage.parse_node_storage(node),
          jstorage.parse_node_storage(node))
    vols = pstorage.parse_pod_storage(pod)
    _same(vols, jstorage.parse_pod_storage(pod))
    _same(pstorage.pod_local_pvcs("p", "ns", vols),
          jstorage.pod_local_pvcs("p", "ns", jstorage.parse_pod_storage(pod)))
    nodes = [pstorage.parse_node_storage(node), None]
    assert pstorage.cluster_vg_totals(nodes) == jstorage.cluster_vg_totals(
        [jstorage.parse_node_storage(node), None])


def test_kubeconfig_dump_and_max_cpu_match_jax(tmp_path, monkeypatch):
    """A CR whose kubeConfig is a `kubectl get -o yaml` dump, no apps, a
    workload that fits, and MaxCPU=1: the verdict names the cap; then
    MaxMemory=5: the same; then no cap: Success."""
    objs = list(yaml.safe_load_all(open(_small_cluster(
        tmp_path / "c", num_pods=6, ds=False) + "/pod/workloads.yaml")))
    for f in sorted((tmp_path / "c" / "node").iterdir()):
        objs.append(yaml.safe_load(f.read_text()))
    objs = [o for o in objs if o["metadata"]["name"] != "gone"]
    objs.append({"kind": "Deployment", "metadata": {"name": "big"},
                 "spec": {"replicas": 4, "template": {"spec": {"containers": [
                     {"resources": {"requests": {"cpu": "16",
                                                 "memory": "64Gi"}}}]}}}})
    dump = tmp_path / "dump.yaml"
    dump.write_text(yaml.safe_dump({"apiVersion": "v1", "kind": "List",
                                    "items": objs}))
    cr = tmp_path / "cr.yaml"
    cr.write_text(yaml.safe_dump({
        "apiVersion": "simon/v1alpha1", "kind": "Config",
        "spec": {"cluster": {"kubeConfig": str(dump)}}}))
    argv = ["-f", str(cr), "-s", SCHEDULERS["fgd"]]
    for env, word in (("MaxCPU", "cpu"), ("MaxMemory", "memory"), (None, "")):
        for name in ("MaxCPU", "MaxMemory"):
            monkeypatch.delenv(name, raising=False)
        if env:
            monkeypatch.setenv(env, "1")
        port, jax = _apply_both(argv)
        assert port == jax
        assert (f"of {word} goes beyond" in port) if env else (
            "Success!" in port)


@pytest.mark.parametrize("flag", sorted(papply.REFUSED_OPTIONS))
def test_refused_options_raise(flag):
    """Every tpusim apply option whose plane the port lacks raises
    NotImplementedError naming its ROADMAP item, before anything runs."""
    default = getattr(papply.ApplyOptions(), flag)
    value = {bool: True, int: 7, float: 2.5, str: "x"}[type(default)]
    opts = papply.ApplyOptions(
        simon_config=os.path.join(REPO, "example/test-cluster-config.yaml"),
        **{flag: value})
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item"):
        papply.Applier(opts)


@pytest.mark.parametrize("case", ["engine", "sequential", "mesh",
                                  "deschedule", "extenders", "kubeconfig"])
def test_refused_configs_raise(tmp_path, case):
    """The CR and scheduler-config settings the port cannot run raise
    NotImplementedError naming the ROADMAP item, through the CLI."""
    custom = {"engine": {"engine": "table"},
              "sequential": {"engine": "sequential"},
              "mesh": {"mesh": 2},
              "deschedule": {"descheduleConfig": {"ratio": 0.2,
                                                  "policy": "cosSim"}},
              }.get(case, {})
    cluster = {"customConfig": os.path.join(REPO, "example/test-cluster")}
    if case == "kubeconfig":
        kc = tmp_path / "kubeconfig"
        kc.write_text(yaml.safe_dump({
            "apiVersion": "v1", "kind": "Config",
            "clusters": [{"name": "c", "cluster": {"server": "https://x"}}]}))
        cluster = {"kubeConfig": str(kc)}
    cr = tmp_path / "cr.yaml"
    cr.write_text(yaml.safe_dump({
        "apiVersion": "simon/v1alpha1", "kind": "Config",
        "spec": {"cluster": cluster, "customConfig": custom}}))
    sc = SCHEDULERS["fgd"]
    if case == "extenders":
        sc = tmp_path / "sc.yaml"
        sc.write_text(yaml.safe_dump({
            "apiVersion": "kubescheduler.config.k8s.io/v1beta1",
            "kind": "KubeSchedulerConfiguration",
            "extenders": [{"urlPrefix": "http://x/"}]}))
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item"):
        pcli.main(["apply", "-f", str(cr), "-s", str(sc), "--device",
                   "cpu"])


def test_apply_runs_on_cuda_by_default(monkeypatch):
    """Without --device the replays run on the GPU: here, where none is
    visible, apply raises as Simulator does."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pcli.main(["apply", "-f", os.path.join(
            REPO, "example/test-cluster-config.yaml"), "-s",
            SCHEDULERS["fgd"], "--base-dir", REPO])


def test_module_entry_dispatches_apply(capsys):
    """`python -m tpusim_torch apply ...` is the cli's apply."""
    argv = ["apply", "-f", os.path.join(REPO, "example/test-cluster-config.yaml"),
            "-s", SCHEDULERS["fgd"], "--base-dir", REPO, "--device", "cpu"]
    assert port_main(argv) == 0
    first = capsys.readouterr().out
    assert pcli.main(argv) == 0
    assert capsys.readouterr().out == first and "Success!" in first


@pytest.mark.parametrize("ratio", ["1.2", "1.5"])
def test_cli_inflation_matches_run_py(tmp_path, capsys, ratio):
    """`python -m tpusim_torch --workload-inflation-ratio R -seed S -d DIR`
    against experiments/run.py with the same flags on the 60-node, 200-pod
    cut: simon.log (without [Engine]) and the CSVs byte for byte."""
    nodes, pods = _cut(tmp_path)
    common = ["-f", pods, "--node-trace", nodes, "-tune", "1.3",
              "-tuneseed", "42", "--shuffle-pod", "true", "-FGD", "1000",
              "-gpusel", "FGDScore", "--workload-inflation-ratio", ratio,
              "-seed", "7"]
    assert port_main(["--device", "cpu", "-d", str(tmp_path / "port"),
                      *common]) == 0
    run_experiment(run_args(["-d", str(tmp_path / "jax"), *common]))
    capsys.readouterr()
    want = chip_smoke.report_digests(tmp_path / "jax")
    assert chip_smoke.report_digests(tmp_path / "port") == want
    with open(tmp_path / "port" / "simon.log") as f:
        assert "ScheduleInflation" in f.read()


# ---- the openb apply (slow) ----

# `python -m tpusim apply` on the openb gpu_node list and default trace as
# YAML, FGD (example/test-scheduler-config.yaml), tuned to 1.3 with seed
# 42, shuffled, the snapshot exports, -e gpu --report, without apps or
# inflation: apply_digests of its output (tpusim on the CPU)
OPENB_APPLY_SHA256 = {
    "stdout":
        "cae80c6bff5bb64bcd69930cd29fe43a28b0082870246c7eb4203494d6738ea7",
    "pod_init_schedule.yaml":
        "6810e19aa47827cac6f622bedc04b49a5c72e7ec089d0f35e03f91b3a8f53088",
    "node_init_schedule.csv":
        "86cd8a9712920d95092aacf701017a641e853e104eebf20b0f8e1386129f060b",
    "node_init_schedule_pod.csv":
        "54725fb7b52c1dc589c9456efc722ba67d57406d345e975cde07dbd61e615a73",
}


def _openb_applies(tmp_path, **bundle):
    """apply_digests of the port's apply --device cpu and of tpusim's on
    the openb bundle of chip_smoke.write_apply_bundle(**bundle)."""
    cluster = chip_smoke.openb_yaml(str(tmp_path))
    pinned = min(n.name for n in pk8s.load_cluster_from_dir(cluster).nodes)
    crs = [chip_smoke.write_apply_bundle(str(tmp_path / side), cluster,
                                         pinned, **bundle)
           for side in ("port", "jax")]
    common = ["-s", os.path.join(REPO, chip_smoke.APPLY_SCHEDULER), "-e",
              "gpu", "--report"]
    outs = _apply_both(["-f", crs[0], *common], ["-f", crs[1], *common])
    return [chip_smoke.apply_digests(out, str(tmp_path / side / "out"))
            for out, side in zip(outs, ("port", "jax"))]


@pytest.mark.slow
def test_openb_apply_matches_jax(tmp_path):
    """The openb apply without apps or inflation: the port's standard
    output and exported files, and tpusim's, have the digests the JAX
    package gave on this CPU (OPENB_APPLY_SHA256)."""
    port, jax = _openb_applies(tmp_path, apps=False, inflation=1.0)
    assert jax == OPENB_APPLY_SHA256
    assert port == jax


@pytest.mark.slow
def test_apply_digests_pin_chip_smoke(tmp_path):
    """chip_smoke.py's apply phase (the YAML app, the chart, inflation 1.1
    on top of the openb apply): tpusim's digests are the ones chip_smoke
    holds the card to, and the port's CPU run gives the same."""
    port, jax = _openb_applies(tmp_path)
    assert jax == chip_smoke.APPLY_SHA256
    assert port == jax
