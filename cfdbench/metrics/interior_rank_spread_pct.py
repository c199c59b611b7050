"""interior_rank_spread_pct (exchange across cards: `ops/blocksweep.py` →
`csrc/sweep_overlap.cu`, K3's peer form with its push and flag waits,
`csrc/push_common.cuh`): over the ranks, 100 × (the longest − the
shortest) ÷ the longest device us per step of the records whose name holds
`sweep_overlap` (the fused interior sweep with its push).  Each card holds
a like share of the mesh, so the spread is what a card spends beyond the
others: spinning on a slower peer's flags, or a slower card.  None with
fewer than two ranks or where no rank has such a record."""

from cfdbench.metrics import per_step_us

OVERLAP = "sweep_overlap"


def read(ranks, problem):
    us = [per_step_us(r, lambda n: OVERLAP in n) for r in ranks]
    us = [u for u in us if u > 0]
    if len(ranks) < 2 or len(us) < 2:
        return None
    return 100.0 * (max(us) - min(us)) / max(us)
