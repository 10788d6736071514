"""The partition plan's apply at the traffic's column count (`cols`) as a
share of its roofline: the least time of the host factorization's work at
the published peaks over the device time of one apply in the traced
window (everything launched inside the program's `PartitionPlan.apply`,
divided by its calls)."""

import torch

from portbench import roofline


def read(run):
    span = run.traced.spans.get("plan") if run.traced else None
    if not span or span["device_s"] <= 0 or not run.on_card:
        return None
    cols = int(run.cell.traffic["cols"])
    share = roofline.roofline_share(
        roofline.operator_work(run.system.host_op, cols),
        span["device_s"] / span["calls"],
        torch.cuda.get_device_name(run.device))
    run.state.setdefault("roofline", {})[cols] = share
    return share["share_pct"]
