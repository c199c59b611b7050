"""idle_in_runner_ms (dispatch: `models/compiled.py` `runner`): idle device
ms per report interval while the host was inside the port's span
cfd.runner (its check and lookup, the state's copies, the replays), from
`cfdbench/idle.py`'s split of the traced stretch; the highest rank's.  None
where the trace holds no cfd.runner span."""


def read(ranks, problem):
    got = [r["idle_by_host"]["within"]["cfd.runner"] * 1e-3 / r["intervals"]
           for r in ranks
           if "cfd.runner" in r.get("idle_by_host", {}).get("within", {})]
    return max(got) if got else None
