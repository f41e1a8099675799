// Bellman expected-fragmentation value function, evaluated on the host.
//
// The recursion of tpusim_torch/ops/frag.py node_frag_bellman (the
// reference's NodeGpuFragBellman, frag.go:231-283): memoized over
// (cpu_left, device vector sorted descending, gpu_type) states against a
// typical-pod distribution, with the same cum_prob cutoff, the 0.999
// ratio-except-Q3 shortcut, and a depth guard whose cut values are not
// memoized. tests/test_torch_report_ops.py holds it to that function and to
// the JAX package's evaluator.
//
// C ABI (bound with ctypes by tpusim_torch/native/__init__.py):
//   bellman_new(cpu[], milli[], num[], mask[], freq[], T, max_depth) -> handle
//   bellman_eval(handle, cpu_left, gpu[8], gpu_type) -> double
//   bellman_series(handle, n, cpu_left[], gpu_left[], gpu_type[],
//                  e, ev_node[], ev_dev[], ev_sign[], ev_cpu[], ev_gpu[],
//                  out[]) -> 0
//   bellman_memo_size(handle) -> size
//   bellman_truncations(handle) -> count
//   bellman_max_depth_seen(handle) -> depth
//   bellman_free(handle)
//
// bellman_series is the per-event cluster series (the `(bellman)` [Report]
// line, analysis.go:110) in one call: it replays the node state from the
// replay's telemetry and evaluates only the node each event touches (the
// value depends on the node's state alone).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <functional>  // std::greater — not transitively provided by every
                       // libstdc++; older toolchains fail the on-demand build
#include <vector>

namespace {

constexpr int kMaxGpus = 8;

// Node state key packed into three 64-bit words: (cpu|type, g[0..3],
// g[4..7]). Word-wise compare + a 3-word mix hash keep the memo's inner
// loop (hundreds of probes per rec expansion) branch-light.
struct Key {
    uint64_t w0, w1, w2;
    bool operator==(const Key& o) const {
        return w0 == o.w0 && w1 == o.w1 && w2 == o.w2;
    }
};

inline Key make_key(int32_t cpu, int32_t type, const int16_t* g) {
    Key k;
    k.w0 = (static_cast<uint64_t>(static_cast<uint32_t>(cpu)) << 32) |
           static_cast<uint32_t>(type);
    std::memcpy(&k.w1, g, 8);
    std::memcpy(&k.w2, g + 4, 8);
    return k;
}

inline uint64_t mix64(uint64_t x) {
    x ^= x >> 33;
    x *= 0xff51afd7ed558ccdull;
    x ^= x >> 33;
    x *= 0xc4ceb9fe1a85ec53ull;
    x ^= x >> 33;
    return x;
}

inline uint64_t key_hash(const Key& k) {
    return mix64(k.w0 ^ mix64(k.w1 ^ mix64(k.w2)));
}

// Open-addressing memo (linear probing, power-of-two capacity). The
// ~200k-state memo a full-trace series accumulates made std::unordered_map
// the evaluator's dominant cost; a flat table roughly halves series time.
class FlatMap {
  public:
    FlatMap() { rehash(1 << 16); }

    // returns pointer to value if present, else nullptr
    const double* find(const Key& k) const {
        size_t i = key_hash(k) & mask_;
        while (used_[i]) {
            if (keys_[i] == k) return &vals_[i];
            i = (i + 1) & mask_;
        }
        return nullptr;
    }

    void insert(const Key& k, double v) {
        if ((count_ + 1) * 10 >= capacity_ * 7) rehash(capacity_ * 2);
        size_t i = key_hash(k) & mask_;
        while (used_[i]) {
            if (keys_[i] == k) {
                vals_[i] = v;
                return;
            }
            i = (i + 1) & mask_;
        }
        used_[i] = 1;
        keys_[i] = k;
        vals_[i] = v;
        ++count_;
    }

    size_t size() const { return count_; }

  private:
    void rehash(size_t cap) {
        std::vector<uint8_t> used(cap, 0);
        std::vector<Key> keys(cap);
        std::vector<double> vals(cap);
        size_t mask = cap - 1;
        for (size_t i = 0; i < capacity_; ++i) {
            if (!used_[i]) continue;
            size_t j = key_hash(keys_[i]) & mask;
            while (used[j]) j = (j + 1) & mask;
            used[j] = 1;
            keys[j] = keys_[i];
            vals[j] = vals_[i];
        }
        used_ = std::move(used);
        keys_ = std::move(keys);
        vals_ = std::move(vals);
        capacity_ = cap;
        mask_ = mask;
    }

    std::vector<uint8_t> used_;
    std::vector<Key> keys_;
    std::vector<double> vals_;
    size_t capacity_ = 0;
    size_t mask_ = 0;
    size_t count_ = 0;
};

// Branchless descending sort of 8 int16s (Batcher odd-even merge network,
// 19 compare-exchanges) — replaces the std::sort call each child state
// re-sort paid in the recursion's hottest loop.
inline void sort8_desc(int16_t* g) {
#define CSWP(a, b)                          \
    {                                       \
        int16_t lo = std::min(g[a], g[b]);  \
        int16_t hi = std::max(g[a], g[b]);  \
        g[a] = hi;                          \
        g[b] = lo;                          \
    }
    CSWP(0, 1) CSWP(2, 3) CSWP(4, 5) CSWP(6, 7)
    CSWP(0, 2) CSWP(1, 3) CSWP(4, 6) CSWP(5, 7)
    CSWP(1, 2) CSWP(5, 6)
    CSWP(0, 4) CSWP(1, 5) CSWP(2, 6) CSWP(3, 7)
    CSWP(2, 4) CSWP(3, 5)
    CSWP(1, 2) CSWP(3, 4) CSWP(5, 6)
#undef CSWP
}

struct TypicalPod {
    int32_t cpu;
    int32_t milli;
    int32_t num;
    int64_t mask;
    double freq;
    int32_t mi;  // index into Evaluator::millis (-1: milli == 0) — avoids
                 // the per-row linear milli lookup in the recursion's two
                 // hottest loops
};

struct Evaluator {
    std::vector<TypicalPod> pods;
    std::vector<int32_t> millis;  // distinct positive, ascending
    int max_depth;
    int64_t truncations = 0;  // times the depth cutoff fired (see below)
    int max_depth_seen = 0;   // deepest recursion level reached
    FlatMap memo;

    double rec(int32_t cpu_left, int16_t* g /* sorted desc */, int32_t type,
               double cum_prob, int depth) {
        Key key = make_key(cpu_left, type, g);
        if (const double* v = memo.find(key)) return *v;

        int64_t total = 0;
        for (int i = 0; i < kMaxGpus; ++i) total += g[i];
        if (total == 0 || static_cast<double>(total) * cum_prob < 1.0)
            return 0.0;

        // fit count per distinct milli (g sorted desc -> prefix counts)
        int nfit[64];
        {
            int i = kMaxGpus;
            for (size_t mi = 0; mi < millis.size(); ++mi) {
                int32_t m = millis[mi];
                while (i > 0 && g[i - 1] < m) --i;
                nfit[mi] = i;
            }
        }
        auto fit_of = [&](const TypicalPod& t) {
            return t.mi >= 0 ? nfit[t.mi] : 0;
        };
        int64_t node_bit = type >= 0 ? (1ll << type) : 0;

        double ratio_except_q3 = 0.0;
        for (const auto& t : pods) {
            if (t.milli == 0 || (t.mask != 0 && !(t.mask & node_bit)) ||
                fit_of(t) < t.num || cpu_left < t.cpu)
                ratio_except_q3 += t.freq;
        }
        if (depth > max_depth_seen) max_depth_seen = depth;
        if (depth >= max_depth) {
            // the Go reference has no depth limit (frag.go:231-283); this
            // guard exists only for pathological distributions, and the
            // counter lets callers assert it never fires on real traces
            ++truncations;
            return static_cast<double>(total);
        }

        double frag;
        if (ratio_except_q3 < 0.999) {
            double pv = 0.0;
            for (const auto& t : pods) {
                if (t.freq == 0.0) continue;  // zero-frequency padding rows
                if (cpu_left < t.cpu || kMaxGpus < t.num) {
                    pv += static_cast<double>(total) * t.freq;
                    continue;
                }
                if (t.num == 0 || t.milli == 0) {
                    pv += t.freq * rec(cpu_left - t.cpu, g, type,
                                       cum_prob * t.freq, depth + 1);
                    continue;
                }
                int j = fit_of(t);
                if (j < t.num) {
                    pv += static_cast<double>(total) * t.freq;
                    continue;
                }
                // take the t.num least-free fitting: g[j-num..j), each
                // -milli; re-sort desc
                int16_t g2[kMaxGpus];
                std::memcpy(g2, g, sizeof(g2));
                for (int d = j - t.num; d < j; ++d)
                    g2[d] = static_cast<int16_t>(g2[d] - t.milli);
                sort8_desc(g2);
                pv += t.freq * rec(cpu_left - t.cpu, g2, type,
                                   cum_prob * t.freq, depth + 1);
            }
            frag = pv;
        } else {
            frag = static_cast<double>(total);
        }
        memo.insert(key, frag);
        return frag;
    }
};

}  // namespace

extern "C" {

void* bellman_new(const int32_t* cpu, const int32_t* milli,
                  const int32_t* num, const int64_t* mask,
                  const double* freq, int32_t t, int32_t max_depth) {
    auto* ev = new Evaluator();
    ev->max_depth = max_depth;
    ev->pods.reserve(t);
    // zero-frequency rows (typical-axis padding) contribute exactly 0.0 to
    // every freq-weighted sum, so dropping them here is bit-identical and
    // shrinks the recursion's per-miss loops
    for (int i = 0; i < t; ++i)
        if (freq[i] != 0.0)
            ev->pods.push_back({cpu[i], milli[i], num[i], mask[i], freq[i], -1});
    std::vector<int32_t> ms;
    for (const auto& p : ev->pods)
        if (p.milli > 0) ms.push_back(p.milli);
    std::sort(ms.begin(), ms.end());
    ms.erase(std::unique(ms.begin(), ms.end()), ms.end());
    if (ms.size() > 64) { delete ev; return nullptr; }
    ev->millis = std::move(ms);
    for (auto& p : ev->pods)
        if (p.milli > 0)
            p.mi = static_cast<int32_t>(
                std::lower_bound(ev->millis.begin(), ev->millis.end(), p.milli)
                - ev->millis.begin());
    return ev;
}

double bellman_eval(void* handle, int32_t cpu_left, const int32_t* gpu,
                    int32_t gpu_type) {
    auto* ev = static_cast<Evaluator*>(handle);
    int16_t g[kMaxGpus];
    for (int i = 0; i < kMaxGpus; ++i) g[i] = static_cast<int16_t>(gpu[i]);
    sort8_desc(g);
    return ev->rec(cpu_left, g, gpu_type, 1.0, 0);
}

// Per-event cluster Bellman series. State arrays are the replay's INITIAL
// node state (cpu_left[n], gpu_left[n*8] unsorted, gpu_type[n]); events
// carry the touched node (-1 = none: skip/failed events keep the previous
// total), the bool[8] touched-device mask, the sign (+1 create, -1 delete)
// and the pod's cpu/gpu milli. out[e] = sum over nodes of the memoized
// value after applying events 0..e.
int32_t bellman_series(void* handle, int32_t n, const int32_t* cpu_left,
                       const int32_t* gpu_left, const int32_t* gpu_type,
                       int64_t e, const int32_t* ev_node,
                       const uint8_t* ev_dev, const int8_t* ev_sign,
                       const int32_t* ev_cpu, const int32_t* ev_gpu,
                       double* out) {
    auto* ev = static_cast<Evaluator*>(handle);
    std::vector<int32_t> cpu(cpu_left, cpu_left + n);
    std::vector<int32_t> gpu(gpu_left, gpu_left + n * kMaxGpus);
    std::vector<double> val(n);
    auto eval_node = [&](int32_t i) {
        int16_t g[kMaxGpus];
        for (int d = 0; d < kMaxGpus; ++d)
            g[d] = static_cast<int16_t>(gpu[i * kMaxGpus + d]);
        std::sort(g, g + kMaxGpus, std::greater<int16_t>());
        return ev->rec(cpu[i], g, gpu_type[i], 1.0, 0);
    };
    double total = 0.0;
    for (int32_t i = 0; i < n; ++i) {
        val[i] = eval_node(i);
        total += val[i];
    }
    for (int64_t k = 0; k < e; ++k) {
        int32_t node = ev_node[k];
        if (node >= 0) {
            int32_t sign = ev_sign[k];
            cpu[node] -= sign * ev_cpu[k];
            for (int d = 0; d < kMaxGpus; ++d)
                if (ev_dev[k * kMaxGpus + d])
                    gpu[node * kMaxGpus + d] -= sign * ev_gpu[k];
            total -= val[node];
            val[node] = eval_node(node);
            total += val[node];
        }
        out[k] = total;
    }
    return 0;
}

int64_t bellman_memo_size(void* handle) {
    return static_cast<int64_t>(
        static_cast<Evaluator*>(handle)->memo.size());
}

int64_t bellman_truncations(void* handle) {
    return static_cast<Evaluator*>(handle)->truncations;
}

int32_t bellman_max_depth_seen(void* handle) {
    return static_cast<Evaluator*>(handle)->max_depth_seen;
}

void bellman_free(void* handle) { delete static_cast<Evaluator*>(handle); }

}  // extern "C"
