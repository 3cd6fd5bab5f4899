"""Tracker configuration (a copy of pvot/config.py).

Copied, not imported: importing anything under `pvot` imports JAX
(pvot/__init__.py), and the port runs without it.  tests/test_torch_imports.py
holds the fields and defaults equal to the original.

Every compile-time constant of the reference tracker becomes a runtime flag here
(reference: tracker_ghc/src/main.cpp:10-23 defines them as `static const`, and
README.md:120-126 documents them as edit-the-source-to-change).  Defaults match
the reference's GHC tree exactly.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    """All knobs of the sequential tracking state machine.

    Attributes mirror tracker_ghc/src/main.cpp:10-23:
      search_radius_x/y   -- SEARCH_RADIUS_X/Y (local window half-size, px)
      batch_size          -- BATCH_SIZE (look-ahead frames per dispatch)
      min_confidence      -- NCC_MIN_CONFIDENCE (local-search accept gate)
      global_confidence   -- NCC_GLOBAL_CONFIDENCE (global-search accept gate)
      strong_confidence   -- NCC_STRONG_CONFIDENCE (template-update gate)
      template_update_lr  -- TEMPLATE_UPDATE_LR (EMA blend weight of new patch)
      lost_frame_threshold-- LOST_FRAME_THRESHOLD (frames before global search)
    """

    search_radius_x: int = 60
    search_radius_y: int = 60
    batch_size: int = 4
    min_confidence: float = 0.4
    global_confidence: float = 0.6
    strong_confidence: float = 0.7
    template_update_lr: float = 0.1
    lost_frame_threshold: int = 50
    # Lost-object global re-acquisition (C8) exists only in the reference's
    # feature-complete GHC main; the Windows tree / main_old variants lack it
    # (SURVEY.md §2a C8).  False reproduces those variants: the tracker never
    # enters sticky global mode.  The collapsed-window full-map fallback stays
    # on even then — a deliberate robustness addition; the Windows tree has no
    # such fallback (tracker/src/main.cpp:141-150 builds the cv::Rect from the
    # clamped bounds unconditionally and would misbehave on a collapsed
    # window).
    enable_global_search: bool = True

    def validate(self) -> "TrackerConfig":
        if self.search_radius_x < 1 or self.search_radius_y < 1:
            raise ValueError("search radii must be >= 1")
        if self.batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        if not (0.0 <= self.template_update_lr <= 1.0):
            raise ValueError("template_update_lr must be in [0, 1]")
        return self


# The reference's Windows tree uses 80-px radii (tracker/src/main.cpp:11-12)
# and has no lost-object global re-acquisition (C8 is GHC-tree only).
WINDOWS_TREE_CONFIG = TrackerConfig(
    search_radius_x=80, search_radius_y=80, enable_global_search=False
)

DEFAULT_CONFIG = TrackerConfig()
