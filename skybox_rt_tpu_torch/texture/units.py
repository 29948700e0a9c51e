"""Multi-stage texture units — the vx_tex(stage, u, v, lod) surface.

Counterpart of skybox_rt_tpu.texture.units.  The reference exposes
VX_TEX_STAGE_COUNT (=2) sampler stages, each with its own DCR block selected
by writing VX_DCR_TEX_STAGE before the stage-local registers
(graphics.h:150-181, VX_types.vh:332-343).  A stage is a (TextureState,
texel table) pair; :func:`sample` dispatches on a Python stage index, fixed
per drawcall like the DCR state.  Texel tables are int32-pattern tensors
(core.fixed), one a bound stage, and the sample runs on their device.
"""
from __future__ import annotations

import dataclasses

from ..core import constants as C
from . import sampler as sampler_mod

STAGE_COUNT = C.TEX_STAGE_COUNT          # VX_TEX_STAGE_COUNT


@dataclasses.dataclass(frozen=True)
class TextureUnits:
    """Bound sampler stages (index -> state); the texel tables live beside
    the states and are passed to :func:`sample`."""
    states: tuple                    # tuple[TextureState | None, ...]

    def __post_init__(self):
        if len(self.states) > STAGE_COUNT:
            raise ValueError(
                f"{len(self.states)} stages > VX_TEX_STAGE_COUNT "
                f"({STAGE_COUNT})")

    def state(self, stage: int) -> sampler_mod.TextureState:
        st = self.states[stage]
        if st is None:
            raise ValueError(f"stage {stage} not bound")
        return st


def bind(*stage_states) -> TextureUnits:
    """bind(state0, state1, ...) -> TextureUnits (None = unbound slot)."""
    return TextureUnits(states=tuple(stage_states))


def sample(units: TextureUnits, texel_arrays, stage: int, u, v,
           lod: int = 0):
    """vx_tex(stage, u, v, lod): the shared sampler on the stage's state and
    table.  texel_arrays: a sequence of int32-pattern tables, one a bound
    stage; u, v raw fixed23 int32.  Returns packed ARGB int32 patterns."""
    return sampler_mod.sample(units.state(stage), texel_arrays[stage],
                              u, v, lod=lod)
