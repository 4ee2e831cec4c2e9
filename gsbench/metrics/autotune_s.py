"""Sizing the budgets over the cell's views in set-up (core/autotune:
measure_occupancy over every view, then derive_caps), timed by the
harness's span, device synchronised at both ends, in s. Moves setup_s."""


def read(art):
    d = art["spans"].get("autotune")
    if not d:
        return None
    return sum(d)
