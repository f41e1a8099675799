"""Scheduler extenders: the k8s HTTP extender protocol over the tensor state
(counterpart of tpusim/sim/extender.py).

The reference passes configured extenders straight into the vendored
scheduler (simulator.go:196 `scheduler.WithExtenders(...)`), which speaks
the extenderv1 HTTP contract (vendored core/extender.go): each scheduling
cycle, each extender's `filterVerb` receives ExtenderArgs{Pod, Nodes |
NodeNames} and returns a node subset, then `prioritizeVerb` returns a
HostPriorityList whose weighted scores, scaled by MaxNodeScore /
MaxExtenderPriority (100/10), are ADDED to the plugin score sum before
selectHost (generic_scheduler.go:520-560).

The port keeps that contract with a host loop over the events: the
Filter/Score half of each cycle is the sequential oracle's
(tpusim_torch.sim.step.score_pod) on the replay's device, the extender
round-trips splice between it and step.select_and_bind on the host, and
deletions run step.unschedule. Semantics kept from the vendored code:

  - interest gate: an extender with managedResources is only consulted for
    pods requesting one of them (IsInterested); an empty list means every
    pod. GPU requests are surfaced as the openb annotation resource name
    (alibabacloud.com/gpu-milli).
  - filter: missing filterVerb passes all nodes through; a returned name
    not in the input is an error; FailedNodes are simply absent from the
    subset; a transport/Error failure fails the CYCLE (pod unschedulable)
    unless the extender is `ignorable` (findNodesThatPassExtenders).
    DEVIATION: the membership check applies to BOTH payload shapes here,
    while the vendored scheduler only enforces it on the nodeCacheCapable
    NodeNames path; for non-nodeCacheCapable extenders it accepts the
    returned Nodes items verbatim (extender.go:331-335), trusting the
    extender to echo real node objects. This build's nodes are rows of a
    fixed tensor, so an out-of-set name cannot be scheduled onto, and
    raising ExtenderError (or skipping, if ignorable) is the closest
    behaviour; a verbatim-echo extender that renames nodes would proceed
    upstream but fail the cycle here.
  - prioritize: errors are IGNORED (the vendored goroutine drops them);
    combinedScores[host] += score x weight; the sum joins the plugin total
    as combined x (MaxNodeScore / MaxExtenderPriority).
  - nodeCacheCapable: NodeNames-only payloads both ways.
  - bindVerb / preemptVerb are rejected at config parse: binding is a
    tensor update here, not a delegable side effect (config.scheduler).

A cycle waits on HTTP and on the card, so this path serves correctness
and integration (the reference ships no extender experiment);
Simulator.run_events takes it whenever extenders are configured.
"""

from __future__ import annotations

import http.client
import json
import os
import random
import time
import urllib.error
import urllib.request
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpusim_torch.constants import MAX_GPUS_PER_NODE, MAX_NODE_SCORE
from tpusim_torch.ops.prng import split

# extenderv1.MaxExtenderPriority (vendored extender/v1/types.go)
MAX_EXTENDER_PRIORITY = 10

ANNO_GPU_MILLI = "alibabacloud.com/gpu-milli"
ANNO_GPU_COUNT = "alibabacloud.com/gpu-count"
ANNO_GPU_MODEL = "alibabacloud.com/gpu-card-model"

# The retry schedule of an extender POST (tpusim's kube_client schedule):
# connection failures and 429/5xx answers retry with capped exponential
# backoff and jitter, honouring a Retry-After; TPUSIM_HTTP_RETRIES sets the
# attempt count (default 3; 1 disables retrying).
HTTP_RETRY_ATTEMPTS = 3
HTTP_RETRY_BASE_S = 0.5
HTTP_RETRY_CAP_S = 8.0
HTTP_RETRY_STATUSES = frozenset({429} | set(range(500, 600)))
_RETRYABLE_CONN = (ConnectionResetError, ConnectionRefusedError,
                   http.client.RemoteDisconnected, urllib.error.URLError,
                   TimeoutError)


@dataclass(frozen=True)
class ExtenderConfig:
    """One `extenders:` entry of KubeSchedulerConfiguration (the v1beta1
    Extender fields this build supports; apis/config/types.go:109)."""

    url_prefix: str
    filter_verb: str = ""
    prioritize_verb: str = ""
    weight: int = 1
    node_cache_capable: bool = False
    ignorable: bool = False
    # resource names from managedResources[].name; empty = all pods
    managed_resources: Tuple[str, ...] = ()
    http_timeout_s: float = 30.0

    def is_interested(self, pod) -> bool:
        """IsInterested (core/extender.go): no managed resources = every
        pod; otherwise the pod must request one of them."""
        if not self.managed_resources:
            return True
        requested = set()
        if pod.cpu_milli > 0:
            requested.add("cpu")
        if pod.memory_mib > 0:
            requested.add("memory")
        if pod.num_gpu > 0 or pod.gpu_milli > 0:
            requested.add(ANNO_GPU_MILLI)
            requested.add(ANNO_GPU_COUNT)
        return bool(requested & set(self.managed_resources))


class ExtenderError(RuntimeError):
    pass


def _pod_json(pod) -> dict:
    """v1.Pod-shaped payload for one trace pod (the openb annotation
    contract the reference's pods carry, open-gpu-share/utils/const.go)."""
    annotations = {}
    if pod.gpu_milli or pod.num_gpu:
        annotations[ANNO_GPU_MILLI] = str(pod.gpu_milli)
        annotations[ANNO_GPU_COUNT] = str(pod.num_gpu)
    if pod.gpu_spec:
        annotations[ANNO_GPU_MODEL] = pod.gpu_spec
    return {
        "metadata": {"name": pod.name, "annotations": annotations},
        "spec": {
            "containers": [
                {
                    "name": "app",
                    "resources": {
                        "requests": {
                            "cpu": f"{pod.cpu_milli}m",
                            "memory": f"{pod.memory_mib}Mi",
                        }
                    },
                }
            ]
        },
    }


def _node_json(node) -> dict:
    labels = {}
    if node.model:
        labels[ANNO_GPU_MODEL] = node.model
    return {
        "metadata": {"name": node.name, "labels": labels},
        "status": {
            "allocatable": {
                "cpu": f"{node.cpu_milli}m",
                "memory": f"{node.memory_mib}Mi",
                ANNO_GPU_COUNT: str(node.gpu),
            }
        },
    }


def _retry_attempts() -> int:
    try:
        return max(1, int(os.environ.get("TPUSIM_HTTP_RETRIES",
                                         HTTP_RETRY_ATTEMPTS)))
    except ValueError:
        return HTTP_RETRY_ATTEMPTS


def _retry_delay_s(attempt: int, retry_after=None) -> float:
    """Sleep before retry `attempt` (failures so far): a Retry-After in
    delta seconds wins, else base x 2^(attempt-1) capped, with half of it
    jittered."""
    if retry_after is not None:
        try:
            return max(0.0, min(float(retry_after), 4 * HTTP_RETRY_CAP_S))
        except (TypeError, ValueError):
            pass  # the HTTP-date form falls back to the backoff
    delay = min(HTTP_RETRY_BASE_S * (2 ** (attempt - 1)), HTTP_RETRY_CAP_S)
    return delay * (0.5 + 0.5 * random.random())


def _with_backoff(call, max_attempts: int):
    """Run call() -> (code, headers, body) on the retry schedule; the last
    attempt's answer, or its exception, surfaces."""
    for attempt in range(1, max_attempts + 1):
        try:
            code, headers, body = call()
        except _RETRYABLE_CONN:
            if attempt >= max_attempts:
                raise
            time.sleep(_retry_delay_s(attempt))
            continue
        if code in HTTP_RETRY_STATUSES and attempt < max_attempts:
            time.sleep(_retry_delay_s(attempt,
                                      (headers or {}).get("Retry-After")))
            continue
        return code, headers, body


def _post(url: str, payload: dict, timeout: float) -> dict:
    """POST one extender verb on the retry schedule and decode its JSON
    answer. After the schedule the last error surfaces unchanged, so the
    callers' ExtenderError wrapping and `ignorable` policy see it."""
    data = json.dumps(payload).encode()

    def call():
        req = urllib.request.Request(
            url, data=data, headers={"Content-Type": "application/json"},
            method="POST")
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                return resp.status, dict(resp.headers), resp.read()
        except urllib.error.HTTPError as e:
            # retryable statuses re-attempt; any other re-raises below
            return e.code, dict(e.headers or {}), e

    _, _, body = _with_backoff(call, _retry_attempts())
    if isinstance(body, Exception):
        raise body
    return json.loads(body.decode())


class ExtenderClient:
    """Filter/Prioritize round-trips for one configured extender."""

    def __init__(self, cfg: ExtenderConfig):
        self.cfg = cfg

    def _args(self, pod, nodes) -> dict:
        args = {"pod": _pod_json(pod)}
        if self.cfg.node_cache_capable:
            args["nodenames"] = [n.name for n in nodes]
        else:
            args["nodes"] = {"items": [_node_json(n) for n in nodes]}
        return args

    def filter(self, pod, nodes) -> List[str]:
        """Surviving node names (a subset of the input). Raises
        ExtenderError on a transport failure or a result carrying Error or
        unknown names; the caller applies the `ignorable` policy."""
        if not self.cfg.filter_verb:
            return [n.name for n in nodes]
        url = f"{self.cfg.url_prefix.rstrip('/')}/{self.cfg.filter_verb}"
        try:
            result = _post(url, self._args(pod, nodes),
                           self.cfg.http_timeout_s)
        except (urllib.error.URLError, OSError, json.JSONDecodeError) as e:
            raise ExtenderError(f"extender {url} filter failed: {e}") from e
        if result.get("error"):
            raise ExtenderError(
                f"extender {url} returned error: {result['error']}"
            )
        known = {n.name for n in nodes}
        if self.cfg.node_cache_capable and result.get("nodenames") is not None:
            names = list(result["nodenames"])
        elif result.get("nodes") is not None:
            names = [
                item["metadata"]["name"]
                for item in result["nodes"].get("items") or []
            ]
        else:
            names = [n.name for n in nodes]
        for name in names:
            if name not in known:
                raise ExtenderError(
                    f"extender {url} claims a filtered node {name!r} not in "
                    "the input node list"
                )
        return names

    def prioritize(self, pod, nodes) -> Optional[dict]:
        """{node name: extender score}, or None on error (the vendored
        scheduler ignores prioritize errors, generic_scheduler.go:536)."""
        if not self.cfg.prioritize_verb:
            return {}
        url = f"{self.cfg.url_prefix.rstrip('/')}/{self.cfg.prioritize_verb}"
        try:
            result = _post(url, self._args(pod, nodes),
                           self.cfg.http_timeout_s)
            return {
                item["host"]: int(item["score"]) for item in (result or [])
            }
        except (urllib.error.URLError, OSError, json.JSONDecodeError,
                KeyError, TypeError, ValueError):
            return None


def extend_cycle(
    clients: Sequence[ExtenderClient],
    pod_row,
    node_rows,
    feasible: np.ndarray,  # bool[N] plugin-filter survivors
    total: np.ndarray,  # i32[N] weighted plugin scores
) -> Tuple[np.ndarray, np.ndarray, bool]:
    """Splice the extender protocol into one scheduling cycle: filter with
    each interested extender in turn over the surviving set, then add the
    weighted prioritize sum. Returns (feasible, total, ok); ok False means
    a non-ignorable extender failed and the cycle fails the pod."""
    name_to_idx = {n.name: i for i, n in enumerate(node_rows)}
    feasible = np.asarray(feasible).copy()
    total = np.asarray(total).copy()
    interested = [c for c in clients if c.cfg.is_interested(pod_row)]

    # filter phase: sequential subsetting (findNodesThatPassExtenders)
    for c in interested:
        if not c.cfg.filter_verb:
            continue
        nodes = [node_rows[i] for i in np.flatnonzero(feasible)]
        if not nodes:
            break
        try:
            survivors = c.filter(pod_row, nodes)
        except ExtenderError:
            if c.cfg.ignorable:
                continue
            return feasible, total, False
        keep = np.zeros_like(feasible)
        for name in survivors:
            keep[name_to_idx[name]] = True
        feasible &= keep

    # prioritize phase: combinedScores scaled into the plugin range
    # (generic_scheduler.go:555-557)
    combined = np.zeros(len(node_rows), np.int64)
    nodes = [node_rows[i] for i in np.flatnonzero(feasible)]
    if nodes:
        for c in interested:
            scores = c.prioritize(pod_row, nodes)
            if not scores:
                continue
            for name, score in scores.items():
                idx = name_to_idx.get(name)
                if idx is not None:
                    combined[idx] += score * c.cfg.weight
    total = total + (
        combined * (MAX_NODE_SCORE // MAX_EXTENDER_PRIORITY)
    ).astype(np.int32)
    return feasible, total, True


def make_extender_replay(policies, gpu_sel: str,
                         extenders: Sequence[ExtenderConfig]):
    """The host loop honouring configured extenders, with the other
    replays' call shape less the types:

        replay(state, specs, ev_kind, ev_pod, tp, key, rank, pod_rows,
               node_rows) -> ReplayResult

    `policies` are (tpusim_torch.policies.Policy, weight) pairs. Without
    extender interference the placements equal the sequential oracle's
    (the same step functions, the same key chain: one split an event,
    k_rand and k_sel from each event's key); the extenders' filter and
    prioritize splice between score_pod and select_and_bind, where the
    vendored scheduler calls them."""
    from tpusim_torch.sim.engine import EV_CREATE, EV_DELETE, ReplayResult
    from tpusim_torch.sim.step import (
        Placement,
        host_pods,
        score_pod,
        select_and_bind,
        unschedule,
    )

    policies = [(pol, int(w)) for pol, w in policies]
    clients = [ExtenderClient(c) for c in extenders]

    def replay(state, specs, ev_kind, ev_pod, tp, key, rank, pod_rows,
               node_rows) -> ReplayResult:
        dev = state.cpu_left.device
        hp = host_pods(specs)
        num_pods = len(hp)
        placed = np.full(num_pods, -1, np.int32)
        masks = np.zeros((num_pods, MAX_GPUS_PER_NODE), bool)
        failed = np.zeros(num_pods, bool)
        ev_kind = np.asarray(ev_kind)
        ev_pod = np.asarray(ev_pod)
        e = len(ev_kind)
        event_node = np.full(e, -1, np.int32)
        event_dev = np.zeros((e, MAX_GPUS_PER_NODE), bool)
        if rank is None:
            rank = torch.arange(state.num_nodes, dtype=torch.int32,
                                device=dev)
        key = tuple(int(w) & 0xFFFFFFFF for w in key)

        for i in range(e):
            kind, idx = int(ev_kind[i]), int(ev_pod[i])
            pod = hp[idx]
            # the sequential oracle's key chain
            key, sub = split(key)
            k_rand, k_sel = split(sub)
            if kind == EV_CREATE:
                feasible, total, sdev = score_pod(state, pod, k_rand,
                                                  policies, gpu_sel, tp)
                feasible_h, total_h, ok = extend_cycle(
                    clients, pod_rows[idx], node_rows,
                    feasible.cpu().numpy(), total.cpu().numpy(),
                )
                if not ok:
                    failed[idx] = True
                    continue
                state, pl = select_and_bind(
                    state, pod, torch.as_tensor(feasible_h, device=dev),
                    torch.as_tensor(total_h, device=dev), sdev, gpu_sel,
                    k_sel, rank)
                node = int(pl.node)
                placed[idx] = node
                masks[idx] = pl.dev_mask.cpu().numpy()
                failed[idx] = node < 0
                event_node[i] = node
                event_dev[i] = masks[idx]
            elif kind == EV_DELETE:
                node, mask = placed[idx], masks[idx]
                state = unschedule(state, pod, Placement(
                    torch.tensor(node, dtype=torch.int32, device=dev),
                    torch.as_tensor(mask, device=dev)))
                event_node[i] = node
                event_dev[i] = mask
                placed[idx] = -1
                masks[idx] = False

        return ReplayResult(
            state,
            torch.as_tensor(placed, device=dev),
            torch.as_tensor(masks, device=dev),
            torch.as_tensor(failed, device=dev),
            None,
            torch.as_tensor(event_node, device=dev),
            torch.as_tensor(event_dev, device=dev),
        )

    return replay
