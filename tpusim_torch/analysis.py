"""The analysis CSVs of one experiment, written from the Simulator's stashes
(counterpart of the direct lane of experiments/analysis.py: fail_table,
build_result_from_sim, analyze_sim and the CSV writers).

The family the paper's figures are drawn from:

  analysis.csv       one summary row: the run's meta, the unscheduled
                     count, each Cluster Analysis block's allocation
                     ratios, amounts and frag-class percentages
  analysis_frag.csv  per event: origin_milli, origin_ratio, origin_q124,
                     bellman_milli, bellman_ratio
  analysis_allo.csv  per event: used nodes, GPUs and GPU milli, total GPUs,
                     arrived GPU milli, used and arrived CPU milli
  analysis_cdol.csv  per event: create/delete/failed/skipped and the count
                     of live pods
  analysis_pwr.csv   per event: cluster, CPU and GPU watts
  analysis_fail.csv  one row per distinct failed request, most frequent
                     first (only when a pod failed)

Every float cell is float() of the very string the log line carries
(reports.event_report_series, cluster_analysis_block), so the CSVs are the
ones the reference's log parser would write from simon.log.
"""

from __future__ import annotations

import csv
import re
from pathlib import Path
from typing import Dict, List

import numpy as np

from tpusim_torch.sim.engine import EV_CREATE, EV_DELETE
from tpusim_torch.sim.reports import pod_resource_repr

# the PodResource.Repr fields the fail table groups by
FAIL_SPEC_RE = re.compile(
    r"<CPU:\s*([\d.]+), GPU: (\d+) x \{(\d+)\s*\}m "
    r"\(CPUREQ: [^)]*\) \(GPUREQ: ([^)]*)\)>"
)


def fail_spec_key(line: str):
    """(cpu_milli, num_gpu, gpu_milli, gpu_type) of a Repr, or None."""
    m = FAIL_SPEC_RE.search(line)
    if not m:
        return None
    return (round(float(m.group(1)) * 1000), int(m.group(2)),
            int(m.group(3)), m.group(4))


def fail_table(fail_specs: Dict[tuple, int]) -> Dict[str, list]:
    """The reference's merged fail schema (merge_fail_pods.py): one row per
    distinct failed request, by frequency, gpu_type "" as "<none>"."""
    fail = {"order": [], "num_pod": [], "cpu_milli": [], "num_gpu": [],
            "gpu_milli": [], "gpu_type_req": []}
    ranked = sorted(fail_specs.items(), key=lambda kv: (-kv[1], kv[0]))
    for order, ((cpu, ngpu, milli, gtype), count) in enumerate(ranked):
        fail["order"].append(order)
        fail["num_pod"].append(count)
        fail["cpu_milli"].append(cpu)
        fail["num_gpu"].append(ngpu)
        fail["gpu_milli"].append(milli)
        fail["gpu_type_req"].append(
            "<none>" if gtype in ("", "ANY", "NONE") else gtype)
    return fail


def _write_series_csv(path: Path, series: Dict[str, list]):
    if not series:
        return
    n = max(len(v) for v in series.values())
    cols = [[str(v[i]) if i < len(v) else "" for i in range(n)]
            for v in series.values()]
    # joined lines are csv.writer's bytes for cells that need no quoting;
    # anything else goes through the writer itself
    if any(any(ch in cell for ch in ',"\r\n') for col in cols for cell in col):
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(series.keys())
            for i in range(n):
                w.writerow([col[i] for col in cols])
        return
    lines = [",".join(series.keys())]
    lines.extend(",".join(row) for row in zip(*cols))
    with open(path, "w", newline="") as f:
        f.write("\r\n".join(lines) + "\r\n")


def _write_experiment_csvs(exp: Path, rows: List[dict], result: dict):
    """The CSV family of one experiment from a build_result_from_sim
    result."""
    cols: List[str] = []
    for r in rows:
        cols.extend(k for k in r if k not in cols)
    with open(exp / "analysis.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=cols)
        w.writeheader()
        w.writerows(rows)
    for name in ("frag", "allo", "cdol", "pwr"):
        _write_series_csv(exp / f"analysis_{name}.csv", result[name])
    # a stale file from an earlier run of this directory must not stay
    fail_csv = exp / "analysis_fail.csv"
    if result["fail"]["order"]:
        _write_series_csv(fail_csv, result["fail"])
    elif fail_csv.exists():
        fail_csv.unlink()


def build_result_from_sim(sim, meta: Dict[str, str] = None) -> dict:
    """The parsed-log result (summary, per-event series, fail table) of the
    last run, from the Simulator's stashes: what its log says, in the
    order the reference's parser would read it."""
    summary: Dict[str, object] = dict(meta or {})
    summary["unscheduled"] = 0
    summary["origin_pods"] = len(sim.workload_pods)
    summary.update(sim.analysis_summary)
    summary["unscheduled"] = len(sim.last_result.unscheduled_pods)

    frag: Dict[str, list] = {}
    allo: Dict[str, list] = {}
    pwr: Dict[str, list] = {}
    cdol = {"id": [], "event": [], "pod_name": [], "cum_pod": []}
    cum = 0
    live = set()
    for rep in sim.event_reports:
        kinds = rep["kinds"]
        active = (kinds == EV_CREATE) | (kinds == EV_DELETE)
        s = rep["series"]
        keys = ["origin_milli", "origin_ratio", "origin_q124"]
        if "bellman_milli" in s:
            keys += ["bellman_milli", "bellman_ratio"]
        for key in keys:
            frag.setdefault(key, []).extend(
                s[key][active].astype(np.float64).tolist())
        for key in ("used_nodes", "used_gpus", "used_gpu_milli"):
            allo.setdefault(key, []).extend(rep[key][active].tolist())
        allo.setdefault("total_gpus", []).extend(
            [int(rep["total_gpus"])] * int(active.sum()))
        for key in ("arrived_gpu_milli", "used_cpu_milli",
                    "arrived_cpu_milli"):
            allo.setdefault(key, []).extend(rep[key][active].tolist())
        for key in ("power_cluster", "power_cluster_CPU",
                    "power_cluster_GPU"):
            pwr.setdefault(key, []).extend(
                s[key][active].astype(np.float64).tolist())
        # the parser's create/delete/failed/skipped timeline over the
        # attempt and rollback lines. A stream has at most one create and
        # one later delete per pod, so a delete deletes a live pod when the
        # pod was created without failure earlier in this replay, or was
        # live before it.
        names, failed = rep["pod_names"], rep["failed"]
        act = np.flatnonzero(active)
        if len(act):
            k_act = kinds[act]
            is_create = k_act == EV_CREATE
            fail_act = failed[act]
            name_act = names[act]
            create_pos = {name_act[j]: j for j in np.flatnonzero(is_create)}
            e_act = len(act)
            cpos = np.fromiter((create_pos.get(n, e_act) for n in name_act),
                               np.int64, count=e_act)
            cposc = np.minimum(cpos, e_act - 1)
            created_ok_before = (cpos < np.arange(e_act)) & ~fail_act[cposc]
            prev_live = np.fromiter((n in live for n in name_act), bool,
                                    count=e_act)
            is_delete_live = ~is_create & (created_ok_before | prev_live)
            verbs = np.where(is_create,
                             np.where(fail_act, "failed", "create"),
                             np.where(is_delete_live, "delete", "skipped"))
            delta = np.where(is_create & ~fail_act, 1,
                             np.where(is_delete_live, -1, 0))
            cums = cum + np.cumsum(delta)
            cum = int(cums[-1])
            for j in np.flatnonzero(is_create & ~fail_act):
                live.add(name_act[j])
            for j in np.flatnonzero(is_delete_live):
                live.discard(name_act[j])
            cdol["id"].extend(act.tolist())
            cdol["event"].extend(verbs.tolist())
            cdol["pod_name"].extend(name_act.tolist())
            cdol["cum_pod"].extend(cums.tolist())

    # the failed-pods blocks' Reprs, grouped as the parser groups them
    fail_specs: Dict[tuple, int] = {}
    for pods in sim.failed_pod_lists:
        for p in pods:
            key = fail_spec_key(pod_resource_repr(
                p.cpu_milli, p.num_gpu, p.gpu_milli, p.gpu_spec))
            if key is not None:
                fail_specs[key] = fail_specs.get(key, 0) + 1

    return {"summary": summary, "frag": frag, "allo": allo, "cdol": cdol,
            "pwr": pwr, "fail": fail_table(fail_specs)}


def analyze_sim(sim, exp_dir: str, meta: Dict[str, str] = None) -> dict:
    """Write the CSV family of the Simulator's last run into `exp_dir`;
    returns the result it was written from."""
    exp = Path(exp_dir)
    result = build_result_from_sim(sim, meta)
    _write_experiment_csvs(exp, [result["summary"]], result)
    return result
