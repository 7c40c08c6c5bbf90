"""The port's spans as the per-layer readers see them (``metrics/*.py``
that read spans): the units that the program recorded in the traced run,
taken from the recorder that the program under test loaded,
``text2img_ekl_tpu_torch.spans`` (its step and sampler import it). Nothing
here imports the port: ``program.py`` alone does. A program without the
recorder, or a run that recorded fewer units than its trace covers, reads
None.

The recorder runs while ``torch.profiler`` records, so both traces of a
``--trace 1`` run record units; the device-only trace comes first, and a
reader takes the first ``trace.units`` units of its root."""

from __future__ import annotations

import sys
from typing import Iterable, List, Optional

RECORDER = 'text2img_ekl_tpu_torch.spans'


def units(trace, root: str) -> Optional[List[dict]]:
    """The device-only trace's units of ``root``, or None."""
    rec = sys.modules.get(RECORDER)
    if trace is None or rec is None:
        return None
    got = rec.units(root, trace.units)
    return got if got and len(got) == trace.units else None


def mean_device_ms(trace, root: str, names: Iterable[str]
                   ) -> Optional[float]:
    """Milliseconds on the card's clock a unit in the spans named
    ``names`` (each from its opening CUDA event to its closing one, so
    the card's idle inside a span counts), summed within each unit and
    averaged over the units; None without such spans or without device
    times."""
    got = units(trace, root)
    if got is None:
        return None
    names = set(names)
    found = [[s['device_ms'] for s in u['spans'] if s['name'] in names]
             for u in got]
    if not any(found) or any(ms is None for f in found for ms in f):
        return None
    return sum(sum(f) for f in found) / len(found)
