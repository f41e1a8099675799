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
ones the reference's log parser would write from simon.log. That parser is
here too (`parse_log`, `analyze_dir`: the log-reading lane of
experiments/analysis.py, `--analysis-from-log`); both lanes write the same
bytes.
"""

from __future__ import annotations

import csv
import re
from pathlib import Path
from typing import Dict, List

import numpy as np

from tpusim_torch.sim.engine import EV_CREATE, EV_DELETE
from tpusim_torch.sim.reports import camel_to_snake, pod_resource_repr

# the Cluster Analysis block's allocation keys and frag-class keys
ALLO_KEYS = ["MilliCpu", "Memory", "Gpu", "MilliGpu"]
QUAD_KEYS = [
    "q1_lack_both",
    "q2_lack_gpu",
    "q3_satisfied",
    "q4_lack_cpu",
    "xl_satisfied",
    "xr_lack_cpu",
    "no_access",
    "frag_gpu_milli",
]
INFOMSG = "level=info msg="

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


def parse_log(path: str, meta: Dict[str, str] = None) -> Dict[str, dict]:
    """One log file -> {"summary", "frag", "allo", "cdol", "pwr", "fail"}:
    the reference's log parser (experiments/analysis.py `parse_log`). It
    stops at the `there are N unscheduled pods` line."""
    summary: Dict[str, object] = dict(meta or {})
    summary["unscheduled"] = 0
    frag: Dict[str, List[float]] = {}
    allo: Dict[str, List[int]] = {}
    pwr: Dict[str, List[float]] = {}
    cdol = {"id": [], "event": [], "pod_name": [], "cum_pod": []}
    fail_specs: Dict[tuple, int] = {}  # (cpu, ngpu, milli, type) -> count
    in_fail_block = False
    cum = 0
    live = set()  # the pods created and not deleted so far
    tag = ""
    analysis_countdown = 0

    with open(path) as f:
        for raw in f:
            if INFOMSG not in raw:
                continue
            line = raw.split(INFOMSG, 1)[1].strip()
            if line.startswith('"'):
                line = line[1:]
            line = line.rstrip('"').rstrip()
            if line.endswith("\\n"):
                line = line[:-2]

            if "Number of original workload pods" in line:
                summary["origin_pods"] = int(line.split(":")[1].strip())
            if "there are" in line and "unscheduled pods" in line:
                summary["unscheduled"] = int(
                    line.split("unscheduled pods")[0].split("there are")[1]
                    .strip())
                break

            # the "Failed Pods in detail:" block (utils.go:1344-1354): its
            # Repr lines grouped by request, as merge_fail_pods.py groups
            if line.startswith("Failed Pods in detail"):
                in_fail_block = True
                continue
            if in_fail_block:
                key = fail_spec_key(line)
                if key is not None:
                    fail_specs[key] = fail_specs.get(key, 0) + 1
                    continue
                in_fail_block = False

            if "Cluster Analysis" in line and "(" in line:
                tag = line.split(")")[0].split("(")[1]
                analysis_countdown = 16
                continue
            if analysis_countdown > 0:
                analysis_countdown -= 1
                item = line.strip().split(":")
                if len(item) > 1:
                    key, value = item[0].strip(), item[1].strip()
                    if key in ALLO_KEYS:
                        summary[camel_to_snake(key + tag)] = float(
                            value.split("%")[0])
                        summary[camel_to_snake(key + "Amount" + tag)] = float(
                            value.split("(")[1].split("/")[0])
                        summary[camel_to_snake(key + "Total")] = float(
                            value.split(")")[0].split("/")[1])
                    elif key in QUAD_KEYS:
                        summary[camel_to_snake(key + tag)] = float(
                            value.split("(")[1].split("%")[0].strip())
                continue

            if line.startswith("[Report]"):
                parts = line.split(";")
                if len(parts) == 5:  # the origin line
                    remark = parts[4].split("(")[1].split(")")[0].strip()
                    frag.setdefault(f"{remark}_milli", []).append(
                        float(parts[1].split(":")[1]))
                    frag.setdefault(f"{remark}_ratio", []).append(
                        float(parts[2].split(":")[1].strip().rstrip("%")))
                    frag.setdefault(f"{remark}_q124", []).append(
                        float(parts[3].split(":")[1].strip().rstrip("%")))
                elif len(parts) == 4:  # the bellman line
                    remark = parts[3].split("(")[1].split(")")[0].strip()
                    frag.setdefault(f"{remark}_milli", []).append(
                        float(parts[1].split(":")[1]))
                    frag.setdefault(f"{remark}_ratio", []).append(
                        float(parts[2].split(":")[1].strip().rstrip("%")))
            elif line.startswith("[Alloc]"):
                parts = line.split(";")
                keys = ["used_nodes", "used_gpus", "used_gpu_milli",
                        "total_gpus", "arrived_gpu_milli"]
                for key, part in zip(keys, parts[1:]):
                    allo.setdefault(key, []).append(
                        int(part.split(":")[1].strip()))
            elif line.startswith("[AllocCPU]"):
                parts = line.split(";")
                for key, part in zip(["used_cpu_milli", "arrived_cpu_milli"],
                                     parts[1:]):
                    allo.setdefault(key, []).append(
                        int(part.split(":")[1].strip()))
            elif line.startswith("[Power]"):
                parts = line.split(";")
                for key, part in zip(["power_cluster", "power_cluster_CPU",
                                      "power_cluster_GPU"], parts[1:]):
                    pwr.setdefault(key, []).append(
                        float(part.split(":")[1].strip()))
            elif line.startswith("[deletePod]") and "non-scheduled" in line:
                if cdol["event"]:  # the create before it failed: roll back
                    cdol["event"][-1] = "failed"
                    cdol["cum_pod"][-1] = cum = cum - 1
                    live.discard(cdol["pod_name"][-1])
            elif ("attempt to" in line and " pod(" in line
                  and line.startswith("[")):
                event_id = int(line.split("]")[0][1:])
                verb = line.split("attempt to ")[1].split()[0]
                pod_name = line.split("pod(")[1].split(")")[0]
                if verb == "create":
                    cum += 1
                    live.add(pod_name)
                elif pod_name in live:
                    cum -= 1
                    live.discard(pod_name)
                else:
                    # the delete of a pod whose create failed: no change
                    # to the count, named apart to keep the events aligned
                    verb = "skipped"
                cdol["id"].append(event_id)
                cdol["event"].append(verb)
                cdol["pod_name"].append(pod_name)
                cdol["cum_pod"].append(cum)

    return {"summary": summary, "frag": frag, "allo": allo, "cdol": cdol,
            "pwr": pwr, "fail": fail_table(fail_specs)}


def analyze_dir(exp_dir: str, meta: Dict[str, str] = None) -> dict:
    """Parse every *.log under exp_dir and write the CSV family beside them
    (one experiment a directory: the series are the last log's). Returns
    the last log's result."""
    exp = Path(exp_dir)
    logs = sorted(exp.glob("*.log"))
    if not logs:
        raise FileNotFoundError(f"no *.log under {exp_dir}")
    rows = []
    result = None
    for log in logs:
        result = parse_log(str(log), meta)
        rows.append(result["summary"])
    _write_experiment_csvs(exp, rows, result)
    return result


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
