"""Model step: the whole step's share of the card's bf16 peak, the
window's nominal operations (``roofline.step_flops`` a step) over its
wall time."""
from portbench import roofline

UNIT = "%"


def read(rec):
    if not rec["steps"]:
        return None
    wl = rec["workload"]
    flops = roofline.step_flops(rec["run"], wl["batch"], wl["seq"]) * rec["steps"]
    return flops / (rec["window_s"] * roofline.PEAK_BF16) * 100
