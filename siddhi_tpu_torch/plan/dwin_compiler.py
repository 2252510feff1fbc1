"""Device window state — not yet ported to the torch backend.

Counterpart of ``siddhi_tpu/plan/dwin_compiler.py`` (device-resident
window buffers under a host selector).  No window kind has a device
kernel in the port yet, so ``DEVICE_KINDS`` is empty: under
``@app:engine('auto')`` every window runs on the host processor, and
under ``'device'`` the query runtime raises with the window's name.
"""
from __future__ import annotations

from ..utils.errors import SiddhiAppCreationError

#: window kinds with a device kernel (read off the AST by
#: analysis/state_schema.py, so keep it a literal)
DEVICE_KINDS = ()


class DeviceWindowProcessor:
    """Placeholder: constructing it always fails (no kind is ported)."""

    def __init__(self, app_ctx, definition, kind, params, compile_expr,
                 pipeline_depth: int = 0):
        raise SiddhiAppCreationError(
            f"device window '{kind}' not yet ported to the torch backend")
