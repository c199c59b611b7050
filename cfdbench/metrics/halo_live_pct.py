"""halo_live_pct (model step and exchange: `models/gradients.py` `_pack`):
100 × the port's counter `halo_live_bytes` ÷ its `halo_bytes` over the
traced stretch, summed over the ranks: the bytes of the send columns that
`send_mask` marks live over the wire bytes the pack writes, padded to
`s_max` in every phase.  None where the pack wrote nothing or the port has
no such counters."""


def read(ranks, problem):
    live = wire = 0
    for r in ranks:
        c = (r.get("spans") or {}).get("counters", {})
        live += c.get("halo_live_bytes", 0)
        wire += c.get("halo_bytes", 0)
    return 100.0 * live / wire if wire > 0 else None
