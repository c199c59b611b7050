"""peer_wait_pct (exchange across cards: the arrival waits of K3's peer
form, `csrc/push_common.cuh::peer_finish_block`): on the rank that waits
most, the device ns a step its last-ticket block spun for its peers'
pushes to land, the port's counter `peer_wait_arrive_ns` over the steps
the harness traced, in % of the port's span cfd.sweep.interior a step (the
fused launch that holds the wait).  The two sit in one unit, ns a launch.
The readiness waits (`peer_wait_barrier_ns`) are left out: a push block
also spins there on its own launch's signal block, 1.9-6.3 us a wait on an
H100 in one process, so those words mix in-launch scheduling with a peer's
lateness.  The counters are the port's own
(`parallel/transport.py::WAIT_COUNTERS`) and reach a rank's summary only
where the span recorder runs inside that rank (`cfdbench/spans_ranks.py`).
None where the counter or the span is missing."""

INTERIOR = "cfd.sweep.interior"


def read(ranks, problem):
    best = None
    for r in ranks:
        sp = r.get("spans") or {}
        c = sp.get("counters", {})
        if "peer_wait_arrive_ns" not in c or INTERIOR not in sp.get(
                "spans", {}) or not sp.get("steps") or not r.get("steps"):
            continue
        wait_ns = c["peer_wait_arrive_ns"] / r["steps"]
        interior_ns = sp["spans"][INTERIOR][1] * 1e6 / sp["steps"]
        if interior_ns > 0 and (best is None or wait_ns > best[0]):
            best = (wait_ns, interior_ns)
    return 100.0 * best[0] / best[1] if best else None
