"""Device-memory budget and the /memz section registry.

The framework-neutral part of the JAX package's ``telemetry/memory.py``:
the operator's declared per-device budget (``PADDLE_HBM_BUDGET_BYTES``,
which sizes the serving KV pool when no page count is given) and the
named /memz sections that subsystems owning big standing allocations
(the KV pool) attach to the payload.  Per-device allocator stats come
from ``torch.cuda.memory_stats``.  The XLA buffer-assignment join and
the OOM doctor are not part of the port.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional

ENV_BUDGET = "PADDLE_HBM_BUDGET_BYTES"


def hbm_budget_bytes() -> Optional[int]:
    """PADDLE_HBM_BUDGET_BYTES — the operator's declared per-device
    ceiling (CI gates, shared-card etiquette). None when unset."""
    raw = os.environ.get(ENV_BUDGET)
    if not raw:
        return None
    try:
        v = int(float(raw))
    except ValueError:
        return None
    return v if v > 0 else None


def device_memory_stats() -> List[dict]:
    """Live allocator stats, one row per visible CUDA device ([] when
    torch has no CUDA)."""
    import torch

    if not torch.cuda.is_available():
        return []
    rows = []
    for i in range(torch.cuda.device_count()):
        st = torch.cuda.memory_stats(i)
        rows.append({
            "device": i,
            "kind": torch.cuda.get_device_name(i),
            "bytes_in_use": int(st.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(st.get("allocated_bytes.all.peak", 0)),
            "bytes_reserved": int(st.get("reserved_bytes.all.current", 0)),
        })
    return rows


#: extra /memz sections registered by subsystems that own big standing
#: allocations (e.g. the serving KV pool) — name -> zero-arg callable
#: returning a JSON-able dict.  A section that raises is reported as an
#: error string instead of killing the page.
_MEMZ_SECTIONS: Dict[str, Callable[[], dict]] = {}


def register_memz_section(name: str, fn: Callable[[], dict]) -> None:
    """Attach a named section to the /memz payload (idempotent: the
    latest registration under a name wins)."""
    _MEMZ_SECTIONS[name] = fn


def unregister_memz_section(name: str) -> None:
    _MEMZ_SECTIONS.pop(name, None)


def memz() -> dict:
    """The /memz payload: the budget, LIVE per-device allocator stats,
    and every registered section."""
    from ..fluid.flags import flag

    devices: List[dict] = []
    try:
        devices = device_memory_stats()
    except Exception:  # noqa: BLE001 — report pages never crash
        pass
    out = {
        "enabled": bool(flag("FLAGS_mem_profile")),
        "budget_bytes": hbm_budget_bytes(),
        "devices": devices,
        "report": None,
    }
    for name, fn in list(_MEMZ_SECTIONS.items()):
        try:
            out[name] = fn()
        except Exception as e:  # noqa: BLE001 — report pages never crash
            out[name] = {"error": f"{type(e).__name__}: {e}"}
    return out
