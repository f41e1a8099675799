"""Where the replay's tables live, and so which replay kernel runs
(counterpart of the residency probes of tpusim/sim/pallas_engine.py:
vmem_resident_bytes, vmem_resident_bytes_hbm, select_residency,
num_normalized).

The JAX package picks between its VMEM-resident kernel and its
HBM-residency kernel by what fits the TPU core's fast memory. On the card
both replay kernels read the tables from device memory through the L2
cache; what differs is the select. The flat `replay` scans the event
type's row over all N nodes each event, which is cheap while the tables
stay in L2. `replay_blocked` keeps 128-node block summaries and selects
over N/128 of them, which pays off once the tables outgrow L2 and every
row scan goes to device memory. The tier names are the JAX package's, so a
`table_residency` setting means the same choice in both packages:

    "vmem"  the tables fit the card's L2 cache: the flat `replay`
    "hbm"   they do not: `replay_blocked`

The rule is a capacity rule, not a measured crossover. On an H100 (50 MiB
L2; chip_smoke.py's scale phase times both kernels, PERF.md §5) the
blocked kernel it picks at 30k and 100k nodes is the faster for FGD,
BestFit and PWR+FGD. At 10k nodes it picks the flat replay, which is not
the faster for every configuration there: under PWR+FGD the flat kernel
took 1.34 times the blocked one's time. The rule does not look at the
configuration's normalisation, which sets the flat kernel's select cost.

A randomized configuration (RandomScore, gpu_sel random) runs "vmem"
whatever the setting: `replay_blocked` does not draw, as tpusim's table
engine runs such a configuration unblocked (`bsz = 0 if has_random`).

There is no third tier: a shape the card's memory cannot hold fails its
allocation before anything is launched.
"""

from __future__ import annotations

RESIDENCIES = ("auto", "vmem", "hbm")
BLOCK = 128  # nodes per block summary


def ceil_block(n: int) -> int:
    """The node count padded to whole 128-node blocks."""
    return -(-n // BLOCK) * BLOCK


def table_bytes(n: int, k: int, num_pol: int) -> int:
    """Bytes of the int32 tables: one score table per policy plus the
    share-device and Filter tables, [K, N] each, N padded to 128."""
    return (num_pol + 2) * k * ceil_block(n) * 4


def blocked_extra_bytes(n: int, k: int, num_norm: int) -> int:
    """Bytes `replay_blocked` adds beside the tables: the block summaries
    bt/br/bn [K, N/128], the block extrema brmin/brmax [nn, K, N/128] and
    the stored extrema slo/shi [nn, K] (nn = max(num_norm, 1)), and the
    padded tie-break rank [N]."""
    nblk = ceil_block(n) // BLOCK
    nn = max(num_norm, 1)
    return ((3 + 2 * nn) * k * nblk + 2 * nn * k + ceil_block(n)) * 4


def select_residency(n: int, k: int, num_pol: int, l2_bytes: int) -> str:
    """"vmem" when the tables fit in `l2_bytes` of L2 cache, else "hbm"."""
    return "vmem" if table_bytes(n, k, num_pol) <= l2_bytes else "hbm"


def replay_tier(setting: str, randomized: bool, n: int, k: int,
                num_pol: int, l2_bytes) -> str:
    """The tier a replay runs in: "vmem" for a randomized configuration;
    else `setting`, or under "auto" select_residency against `l2_bytes`
    of L2 cache ("vmem" where there is no card, `l2_bytes` None)."""
    if randomized:
        return "vmem"
    if setting != "auto":
        return setting
    if l2_bytes is None:
        return "vmem"
    return select_residency(n, k, num_pol, l2_bytes)


def num_normalized(policies) -> int:
    """How many of a configuration's policies are min-max or PWR
    normalised: the rows of the blocked extrema."""
    return sum(1 for pol in policies if pol.normalize != "none")
