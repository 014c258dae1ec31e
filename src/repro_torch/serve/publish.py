"""WA weight publishing: the trainer's W̿ into the serving engine's
params, bit-exact (counterpart of ``repro.serve.publish``).

The trainer's slide-window state (``core.offline.WindowState``) holds W̿
as ONE packed, layout-described buffer, so publishing is a LAYOUT
problem, not a data problem:

    repack(src_buf, src_spec, dst_spec)      # only if the layouts differ
    unpack(dst_buf, dst_spec, like=params)   # leaf views, cast to dtype

Packing never touches values, so the served weights are bitwise the
trainer's W̿ cast to the serving dtypes, whichever layout the snapshot
was written under. The swap itself is a reference swap between steps
(``PagedDecodeEngine.set_params``); the previous params are kept alive
until the next publish (the standby), so nothing still queued on the
device reads memory that was freed.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.common.packing import PackSpec, pack_spec, repack, unpack
from repro_torch.common.pytree import tree_map
from repro_torch.core.offline import window_average_packed


@dataclasses.dataclass
class WeightPublisher:
    """Publishes packed W̿ snapshots into a serving engine's params.
    ``engine`` is any engine that exposes ``params``, ``device`` and
    ``set_params``."""
    engine: object

    def __post_init__(self):
        self.dst_spec: PackSpec = pack_spec(self.engine.params)
        self._standby = None          # params kept alive across one swap
        self.n_published = 0

    def publish_packed(self, buf: torch.Tensor, src_spec: PackSpec):
        """Repack ``buf`` (the trainer's packed W̿ under ``src_spec``)
        into the serving layout, cast it to the serving dtypes and swap
        it in. Returns the new params."""
        buf = buf.to(self.engine.device, torch.float32)
        if not src_spec.same_layout(self.dst_spec):
            buf = repack(buf, src_spec, self.dst_spec)
        like = self.engine.params
        new_params = tree_map(lambda x, p: x.to(p.dtype).contiguous(),
                              unpack(buf, self.dst_spec), like)
        # the previous live params become the standby, kept until the
        # NEXT publish
        self._standby = like
        self.engine.set_params(new_params)
        self.n_published += 1
        return new_params

    def publish_window_state(self, state):
        """Publish W̿ from a live (or freshly loaded) WindowState."""
        return self.publish_packed(*wa_snapshot(state))

    def publish_checkpoint(self, path: str):
        """Publish W̿ straight from a window-state checkpoint file."""
        from repro_torch.checkpoint.io import load_wa_snapshot
        return self.publish_packed(*load_wa_snapshot(path))


def wa_snapshot(state):
    """(packed W̿ f32 buffer, PackSpec) of a WindowState."""
    return window_average_packed(state), state.spec
