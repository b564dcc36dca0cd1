"""What a kernel build reports and what the card's profiler reads, shared
by ``chip_smoke.py`` and the diagnostics beside this module.

``ptxas_entries`` reads registers and spills from an ``nvcc -Xptxas -v``
log; ``kernel_rows`` lists a ``torch.profiler`` run's device kernels;
``device_ms`` times a call's kernels on the card.  Nothing here imports
torch at import time.
"""

from __future__ import annotations

import re


def ptxas_entries(log: str) -> list[tuple[str, str, str]]:
    """(mangled name, ptxas's "Used ..." text, its spill line) of each
    kernel in an ``nvcc -Xptxas -v`` log, in the log's order."""
    out, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and name is not None:
            out.append((name, line.split(":", 1)[-1].strip(), spill))
            name, spill = None, ""
    return out


def kernel_rows(prof) -> list[tuple[float, str, int]]:
    """(device us, name, calls) of each device kernel in a profiler run,
    largest first; a CPU op's "self device time" would repeat them."""
    rows = []
    for ev in prof.key_averages():
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            dev_us = getattr(ev, "self_device_time_total",
                             getattr(ev, "self_cuda_time_total", 0.0))
            rows.append((dev_us, ev.key, ev.count))
    return sorted(rows, reverse=True)


def device_ms(torch, fn, groups: dict, iters: int = 10, tries: int = 3,
              warm: int = 1, log=None) -> dict:
    """Device ms per call of ``fn(i)`` (i the call's index) under
    torch.profiler, which, unlike CUDA events, leaves out the host's launch
    overhead around a short kernel, summed for each group of ``groups``
    (name -> substrings of the kernels' names; None: every device kernel).
    ``warm`` calls come first.  A window in which a group's kernel records
    are not a whole number per call (the profiler dropped some: the sum
    would read low) is taken again, up to ``tries`` windows; a group still
    short is nan (not measured), and ``log``, if given, gets a line saying
    why."""
    from torch.profiler import ProfilerActivity, profile

    for i in range(warm):
        fn(i)
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fn(i)
            torch.cuda.synchronize()
        rows = kernel_rows(prof)
        picked = {g: [r for r in rows
                      if names is None or any(n in r[1] for n in names)]
                  for g, names in groups.items()}
        records = {g: sum(r[2] for r in rs) for g, rs in picked.items()}
        if all(n and n % iters == 0 for n in records.values()):
            break
    out = {}
    for g, rs in picked.items():
        if records[g] and records[g] % iters == 0:
            out[g] = sum(r[0] for r in rs) / 1e3 / iters
            continue
        out[g] = float("nan")
        if log is not None:
            log(f"[profile] {groups[g]}: {records[g]} kernel records over "
                f"{iters} calls in the last of {tries} windows "
                f"({[r[1][:60] for r in rs]}): device time not measured")
    return out
