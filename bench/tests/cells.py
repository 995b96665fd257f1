"""A cell of ``BENCHMARK.json`` cut to a size the CPU runs in seconds:
the network of the port's SMOKE configuration (12x12 input, two conv
layers of 8 channels, T=4) under the cell's own loop, plan variant and
limits."""
from harness import config


def tiny(name: str) -> config.Cell:
    cell = config.load_cell(name)
    net = cell.config["network"]
    net.update({"input_hw": [12, 12], "t_steps": 4, "layers": [
        {"conv": 8, "kernel": 3}, {"conv": 8, "kernel": 3, "pool": 3},
        {"fc": 10}]})
    plan = cell.config["plan"]
    plan.update({"capacity": [144, 144], "channel_block": [8, 8],
                 "event_par": [8, 8]})
    if "variant" in plan:
        plan["variant"] = ["fused-handoff"] * 2
    cell.traffic["inputs"]["pool"] = 64
    if "batch" in cell.traffic:
        cell.traffic["batch"] = 16
    else:
        # under what one CPU serves at this size (~120 requests/s unloaded)
        cell.traffic["arrivals"]["rate_per_s"] = 50
        cell.traffic["engine"]["max_batch"] = 16
    return cell
