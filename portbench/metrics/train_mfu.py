"""Model step: the whole step's share of the card's bf16 peak, the
window's nominal operations (``roofline.step_flops`` a step, as the
configuration's family counts it) over its wall time; left out where the
family gives no count."""
from portbench import roofline

UNIT = "%"


def read(rec):
    if not rec["steps"]:
        return None
    wl = rec["workload"]
    flops = roofline.step_flops(rec["run"], wl["batch"], wl["seq"])
    if flops is None:
        return None
    return flops * rec["steps"] / (rec["window_s"] * roofline.PEAK_BF16) * 100
