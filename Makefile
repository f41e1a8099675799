# Convenience targets (the package is pure Python + an optional on-demand
# C++ component; there is no build step — ref parity: Makefile builds bin/simon).

.PHONY: test test-fast test-tpu test-torch test-cuda bench bench-scale bench-scale-smoke resume-smoke profile-smoke serve-smoke sweep-smoke svc-smoke serve-latency-smoke tune-smoke policy-smoke pallas-hbm-smoke chaos-smoke mesh-chaos-smoke fleet-chaos-smoke fleet-wan-smoke fleet-ha-smoke fleet-trace-smoke slo-smoke bench-gate sweep native clean

# full suite, INCLUDING @pytest.mark.slow tests (pallas interpreter
# sweeps, openb kill/resume, the full Bellman replay)
test:
	python -m pytest tests/ -q

# the tier-1 lane (ROADMAP.md verify command): slow-marked tests excluded
test-fast:
	JAX_PLATFORMS=cpu python -m pytest tests/ -q -m 'not slow'

# on-accelerator lane: golden frag values + engine equivalence on the chip
test-tpu:
	TPUSIM_TPU_TESTS=1 python -m pytest tests/ -m tpu -q

# the PyTorch/CUDA port (tpusim_torch) against the JAX package, on the CPU;
# the card's own check is `python3 chip_smoke.py`
test-torch:
	JAX_PLATFORMS=cpu python -m pytest tests/test_torch_*.py -q

# the port's card-only tests: each CUDA kernel against its plain version
# under every policy configuration (needs a GPU; tests/conftest.py imports
# JAX, which the card's machine does not have, hence --noconftest)
test-cuda:
	python -m pytest --noconftest tests/test_torch_cuda.py -q

bench:
	python bench.py

bench-scale:
	python bench_scale.py

# fast scale-lane regression gate on the CPU backend: 10k nodes trips the
# blocked table-engine select (ENGINES.md "blocked table" row); a few
# thousand pods keep the whole run to a couple of minutes
bench-scale-smoke:
	JAX_PLATFORMS=cpu python bench_scale.py --nodes 10000 --pods 5000 --chunk 5000

# kill/resume gate (ENGINES.md "Checkpoint/resume"): replay an openb
# prefix, kill the run right after a mid-trace checkpoint lands, resume in
# a fresh process, and assert the final placements/metrics/tables are
# byte-identical to the uninterrupted run — plus the fault-injection
# determinism suite, the obs telemetry-continuity/counter-invariance
# suite, and the decision-provenance suite (cross-engine record
# invariance incl. the shard top-K collective, decision-stream
# kill/resume + fault-segment continuity, openb explain/diff goldens),
# and the live-telemetry suite (in-scan series cross-engine invariance,
# series kill/resume + fault-segment continuity, /metrics-vs-textfile
# equality, serve smoke), and the config-axis sweep suite (weight-operand
# cross-engine bit-identity, the B=16 openb acceptance). Runs the full
# files including slow-marked cases (the synthetic kill/resume +
# telemetry subsets are already wired into tier-1).
resume-smoke:
	JAX_PLATFORMS=cpu python -m pytest tests/test_checkpoint.py tests/test_deschedule.py tests/test_fork.py tests/test_faults.py tests/test_fault_lane.py tests/test_obs.py tests/test_decisions.py tests/test_series.py tests/test_sweep.py tests/test_svc.py tests/test_svc_fork.py tests/test_learn.py tests/test_pipeline.py tests/test_fleet.py tests/test_ha.py tests/test_transfer.py tests/test_trace_audit.py tests/test_supervisor.py tests/test_policy_learned.py tests/test_blocked_engine.py tests/test_pallas_hbm.py tests/test_table_engine.py tests/test_parallel.py tests/test_pallas_engine.py tests/test_batch.py tests/test_kube_client.py -q

# config-axis sweep smoke (ENGINES.md "Round 11"): the weight-operand /
# vmapped-sweep suite (cross-engine bit-identity under traced weights,
# the B=16 openb acceptance incl. the one-compile and marginal-cost
# bounds), then a small end-to-end `bench_scale --sweep` row through the
# persistent compilation cache. Runs the slow-marked cases tier-1 skips.
sweep-smoke:
	JAX_PLATFORMS=cpu python -m pytest tests/test_sweep.py -q
	JAX_PLATFORMS=cpu TPUSIM_COMPILE_CACHE_DIR=.tpusim_obs/compile_cache \
		python bench_scale.py --nodes 1500 --pods 2000 --sweep 4

# observability smoke (ENGINES.md "Round 8"/"Round 10"): a small
# profiled scale run emitting the full artifact set — JSONL run record
# (spans with the compile/execute split + exact scan counters + the
# in-scan series block), Prometheus textfile, Chrome-trace timeline
# (with series counter tracks) — under the ignored .tpusim_obs/ scratch
# dir, never the repo root
profile-smoke:
	JAX_PLATFORMS=cpu python bench_scale.py --nodes 2000 --pods 2000 \
		--chunk 1000 --heartbeat 500 --series-every 100 \
		--profile .tpusim_obs/scale_profile.jsonl \
		--metrics-out .tpusim_obs/scale_metrics.prom \
		--trace-out .tpusim_obs/scale_trace.json

# live-monitoring smoke (ENGINES.md "Round 10"): regenerate the profile
# artifacts, then point `tpusim serve --once` at the scratch dir — one
# poll, a real HTTP self-scrape, exit 0 iff /metrics parses as
# exposition text. The long-running form (`tpusim serve .tpusim_obs`)
# is the second-terminal view of a live checkpointed run.
serve-smoke: profile-smoke
	JAX_PLATFORMS=cpu python -m tpusim serve .tpusim_obs --once --listen :0

# replay-service smoke (ENGINES.md "Round 12"): boot `serve --jobs` on
# an ephemeral port, POST a 4-job grid (weights + tune-factor variants
# plus an exact duplicate) over real HTTP, poll to done, and assert the
# service contracts — the duplicate answered from the digest cache, the
# fresh jobs batched onto ONE compiled sweep, and a second weights+tune
# wave adding ZERO executables (jit._cache_size() stable).
svc-smoke:
	JAX_PLATFORMS=cpu python -m tpusim.obs.gate --svc-only

# interactive what-if serving smoke (ENGINES.md "Round 20"): the
# warm-state fork plane over real HTTP — a base job leaves its
# checkpoint ladder + fork-index entry, then a wave of warm forks and
# their from-event-0 "full" twins (more jobs than lanes: late arrivals
# JOIN the running wave at chunk boundaries). Hard checks: every fork
# bit-identical to its twin, every fork executed <= tail + one chunk
# events, wave executables UNCHANGED across the join wave
# (jit._cache_size() live), and the warm forks' admission->result p99
# under the hard SLO AND >= 3x faster than the full-replay p99.
serve-latency-smoke:
	JAX_PLATFORMS=cpu python -m tpusim.obs.gate --serve-latency-only

# learned-scoring smoke (ENGINES.md "Round 13"): run `tpusim tune`'s
# loop on a tiny synthetic trace for 3 generations on the local backend
# and hard-check the lane's contracts — ONE compiled sweep executable
# across every generation (jit._cache_size() stable: weights are traced
# operands, the population is one vmapped scan), the digest-signed
# tuning log reads back, and a resume of the finished log is a
# byte-identical no-op.
tune-smoke:
	JAX_PLATFORMS=cpu python -m tpusim.obs.gate --tune-only

# learned-policy smoke (ENGINES.md "Round 18"): the LearnedScore lane
# end-to-end on a tiny synthetic trace with a forced 2-device virtual
# mesh — imitation round-trip off a recorded FGD teacher (dataset
# builder feasibility cross-check + train + i32 export), the signed
# artifact replaying BIT-identically on the sequential/flat/blocked/
# shard engines, one-executable ES policy search (hard
# jit._cache_size() check), signed-artifact round-trip + torn-file
# rejection, and a served policy preset answering a submit job with
# the exact local placements.
policy-smoke:
	JAX_PLATFORMS=cpu python -m tpusim.obs.gate --policy-only

# HBM-residency pallas smoke (ENGINES.md "Round 19"): the fused Pallas
# engine past the old N <= 4096 VMEM ceiling — a synthetic N=8192/K=151
# trace replayed by the HBM-resident-table kernel in interpreter mode,
# WITHOUT degrading to the blocked table engine, bit-identical
# placements/devices to it; the two-tier residency auto-select pinned
# at both tiers (vmem below the ceiling, hbm above, degrade only when
# neither fits), the documented HBM ceiling >= 256k nodes at K=151,
# and the kernel's exact in-kernel DMA counters (waits == starts — no
# leaked transfers) present in the obs run record.
pallas-hbm-smoke:
	JAX_PLATFORMS=cpu python -m tpusim.obs.gate --pallas-hbm-only

# chaos-sweep smoke (ENGINES.md "Round 14"): a tiny B-lane fault sweep
# (one trace, varying fault seed/MTBF/evict cadence as per-lane
# operands) with the hard contracts — ONE compiled chaos executable, a
# second wave of DIFFERENT schedules adding ZERO executables
# (jit._cache_size() stable), and lane 0's placements +
# DisruptionMetrics reconciling exactly against the standalone
# single-lane run_with_faults path.
chaos-smoke:
	JAX_PLATFORMS=cpu python -m tpusim.obs.gate --chaos-only

# mesh-chaos smoke (ENGINES.md "Round 15"): the pipelined shard engine
# on a small forced-virtual mesh — a FAULTED mesh replay must reconcile
# the single-device fault lane exactly (retry pops + DOWN-row resets
# through the pending registers) with the frag-delta degrade loud, and
# a chunked replay with buffer DONATION armed must hold ONE compiled
# executable across equal-size chunks, consume its input carries, keep
# the live-buffer census stable (nothing re-materialized), and finish
# bit-identical to the one-shot replay. Also prints the advisory
# comparison of the newest committed MULTICHIP_r*.json scale capture.
mesh-chaos-smoke:
	JAX_PLATFORMS=cpu python -m tpusim.obs.gate --mesh-chaos-only

# fleet-chaos smoke (ENGINES.md "Round 16"): the kill-tolerant worker
# fleet end-to-end — a single-worker reference run (cold caches), then
# a coordinator + 3 worker PROCESSES on the same caches with a random
# `kill -9` mid-batch. Hard checks: 100% of accepted jobs reach signed
# results BYTE-identical to the single-worker run, the dead worker's
# leases are stolen without operator action (/queue steals +
# lease_expired), and a fresh joiner's first batch skips the cold
# compile via the shared persistent-compile/table caches.
fleet-chaos-smoke:
	JAX_PLATFORMS=cpu python -m tpusim.obs.gate --fleet-chaos-only

# fleet-wan smoke (ENGINES.md "Round 17"): the wide-area fleet with NO
# shared filesystem — a coordinator hosting TWO traces behind a flaky
# HTTP shim (drops/delays ~20% of transfer requests), a supervisor
# spawning remote-mode workers with fully isolated per-worker dirs
# (digest-verified trace downloads, signed-result uploads, lease
# POSTs), a random `kill -9` of a remote worker mid-batch, and a
# forced crash loop. Hard checks: 100% completion with per-file byte
# identity vs the single-worker reference, the supervisor's respawn
# counter >= 1 in /queue, remote transfer counters live in /workers, a
# torn upload rejected with nothing written, and the crash loop
# tripping the circuit breaker into a loud degraded /healthz instead
# of spinning.
fleet-wan-smoke:
	JAX_PLATFORMS=cpu python -m tpusim.obs.gate --fleet-wan-only

# fleet-ha smoke (ENGINES.md "Round 21"): coordinator failover end to
# end — a token-armed leader + standby CLI pair sharing one artifact
# dir, two workers joined against BOTH urls, jobs submitted through
# the failover client, then `kill -9` of the LEADER while leases are
# held mid-batch. Hard checks: the standby promotes at a bumped epoch
# (role/epoch live on /healthz), workers re-register and finish 100%
# of jobs with per-file byte identity vs a single-coordinator
# reference, a stale-epoch op answers 409, every mutating endpoint
# rejects missing/forged tokens with 401, the resurrected old leader
# fences itself to standby, and token material never reaches /queue.
fleet-ha-smoke:
	JAX_PLATFORMS=cpu python -m tpusim.obs.gate --fleet-ha-only

# fleet-trace smoke (ENGINES.md "Round 22"): the fleet flight recorder
# end-to-end — a coordinator + supervised worker pair over real HTTP,
# jobs submitted BEFORE the workers join, then `kill -9` of the first
# lease-holder mid-batch. Hard checks: every job completes with a
# gap-free stitched cross-process timeline (admission/queue-wait/claim/
# dispatch/upload/verify spans all carrying the ONE trace id minted at
# submit; zero orphan spans; the killed worker's half-open attempt
# stitched as ABANDONED), the `tpusim trace` / `tpusim audit` verbs
# exit 0 against the artifact dir (Chrome-trace export written), the
# hash-chained audit log verifies end-to-end recording BOTH the steal
# and the supervisor's respawn, and the aggregated coordinator
# /metrics parses as exposition text with a worker=-labeled series set
# for every live worker that served a batch.
fleet-trace-smoke:
	JAX_PLATFORMS=cpu python -m tpusim.obs.gate --fleet-trace-only

# SLO-plane smoke (ENGINES.md "Round 23"): the metrics-history +
# burn-rate alerting plane end-to-end over real HTTP. A coordinator
# armed with a tight --slo-file fork-p99 burn rule serves a base run,
# then a COLD fork wave (the induced latency regression) fires the
# burn-rate page — visible on /alerts, flipping /healthz to 503 with
# the alert named, shown by `tpusim top --once`, with the native
# per-kind latency summary on /metrics, the event series on /query,
# cursor pagination on /events, and the kind=alert record in a
# VERIFYING hash-chained audit log — then warm forks (recovery)
# displace the burn windows and the alert RESOLVES under live traffic.
# A forced crash loop trips the supervisor breaker and fires the
# built-in breaker-open page. Finally a leader + standby CLI pair:
# kill -9 the leader, the standby promotes at a bumped epoch and
# ADOPTS the signed tsdb snapshot — /query history splices with no
# gap (pre-kill points within snapshot cadence of the kill).
slo-smoke:
	JAX_PLATFORMS=cpu python -m tpusim.obs.gate --slo-only

# bench regression gate (tpusim.obs.gate): re-run the headline openb FGD
# measurement under profiling and diff it against the newest committed
# BENCH_r*.json baseline — exact on events/placements/gpu_alloc
# (machine-independent), tolerance-gated on same-backend throughput,
# advisory on cross-backend throughput. Also smoke-checks the decision
# JSONL round-trip (ISSUE 4), that a live /metrics scrape of the smoke
# record parses and is byte-equal to the emitted textfile (ISSUE 5),
# the one-compile sweep contract (ISSUE 6), the replay-service POST
# path — dedup + zero recompiles (ISSUE 7, the svc-smoke check) — and
# the interactive what-if serving plane (ISSUE 16, the
# serve-latency-smoke check: warm forks bit-identical to from-0 twins,
# boundary joins with zero recompiles, hard admission->result p99
# SLO), and the learned-scoring loop (ISSUE 9, the tune-smoke check: one
# executable across generations, signed resumable log), and the chaos
# sweep (ISSUE 10, the chaos-smoke check: fault schedules as operands —
# zero recompiles across waves, lane-vs-standalone disruption
# reconciliation), and the worker fleet (ISSUE 12, the
# fleet-chaos-smoke check: kill -9 mid-batch, orphan stealing,
# byte-identical results, warm-joiner compile skip), and the wide-area
# fleet (ISSUE 13, the fleet-wan-smoke check: no-shared-fs workers
# under injected transfer faults, supervisor respawn, circuit
# breaker), and coordinator HA (ISSUE 17, the fleet-ha-smoke check:
# kill -9 the leader mid-batch, epoch-fenced standby takeover, auth
# probes, byte-identity vs a single-coordinator reference), and the
# fleet flight recorder (ISSUE 19, the fleet-trace-smoke check:
# stitched cross-process timelines across a kill -9 + steal, the
# hash-chained audit log, aggregated per-worker /metrics), and the SLO
# plane (ISSUE 20, the slo-smoke check: induced fork regression fires
# a burn-rate page that resolves under recovery traffic, breaker trip
# pages, /query history survives a kill -9 takeover). Exit 1 on
# regression; artifacts land in .tpusim_obs/.
bench-gate:
	JAX_PLATFORMS=cpu python -m tpusim.obs.gate

sweep:
	python experiments/sweep.py

native:
	g++ -O2 -shared -fPIC -o tpusim/native/_bellman.so tpusim/native/bellman.cpp

clean:
	rm -f tpusim/native/_bellman.so
	find . -name __pycache__ -type d -exec rm -rf {} +
