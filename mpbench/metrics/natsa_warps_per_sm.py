"""natsa_warps_per_sm: the NATSA kernel's one-warp blocks a launch over
the card's streaming multiprocessors, from the program's counters
(`natsa.blocks` over `natsa.launches`, every launch of the process, the
warm-up jobs' too, which sweep the window's shapes). None without a
launch, or where the program keeps no such counters."""

import torch


def read(obs):
    try:
        from repro_torch.utils import trace
    except ImportError:
        return None
    counts = trace.counters()
    launches = counts.get("natsa.launches", 0)
    if not launches or not torch.cuda.is_available():
        return None
    sms = torch.cuda.get_device_properties(
        torch.cuda.current_device()).multi_processor_count
    return counts.get("natsa.blocks", 0) / launches / sms
