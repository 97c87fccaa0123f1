"""Input state: pressed keys/buttons -> per-frame ViewerInput.

Capability parity with the reference's input plugin (reference:
src/plugins/input.rs:13-154): pressed-key and pressed-button sets
maintained from key/button down/up events, per-frame cursor delta from the
last cursor position, and wheel accumulation. The key bindings mirror the
fly cam's (src/plugins/camera/fly_cam.rs:69-137): WASD planar,
Space/ShiftLeft ascend/descend, right mouse button to look.

Copy of the reference's ``viewer/input.py``: ``tests/test_torch_tools.py``
holds its results equal to the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .app import ViewerInput

KEY_FORWARD = "w"
KEY_BACK = "s"
KEY_LEFT = "a"
KEY_RIGHT = "d"
KEY_ASCEND = "space"
KEY_DESCEND = "shift"
BUTTON_LOOK = "right"


@dataclass
class InputState:
    pressed_keys: set = field(default_factory=set)
    pressed_buttons: set = field(default_factory=set)
    _cursor: tuple[float, float] | None = None
    _cursor_delta: tuple[float, float] = (0.0, 0.0)
    _wheel: float = 0.0

    # --- event feed -----------------------------------------------------------

    def key_down(self, key: str) -> None:
        self.pressed_keys.add(key.lower())

    def key_up(self, key: str) -> None:
        self.pressed_keys.discard(key.lower())

    def button_down(self, button: str) -> None:
        self.pressed_buttons.add(button.lower())

    def button_up(self, button: str) -> None:
        self.pressed_buttons.discard(button.lower())

    def cursor_moved(self, x: float, y: float) -> None:
        """Accumulate the delta from the last position (input.rs:135-150)."""
        if self._cursor is not None:
            dx = x - self._cursor[0]
            dy = y - self._cursor[1]
            self._cursor_delta = (
                self._cursor_delta[0] + dx,
                self._cursor_delta[1] + dy,
            )
        self._cursor = (x, y)

    def wheel(self, steps: float) -> None:
        self._wheel += steps

    # --- per-frame sample --------------------------------------------------------

    def sample(self) -> ViewerInput:
        """Consume accumulated deltas into one frame's ViewerInput."""
        axis = lambda pos, neg: (
            (1.0 if pos in self.pressed_keys else 0.0)
            - (1.0 if neg in self.pressed_keys else 0.0)
        )
        out = ViewerInput(
            forward=axis(KEY_FORWARD, KEY_BACK),
            right=axis(KEY_RIGHT, KEY_LEFT),
            ascend=axis(KEY_ASCEND, KEY_DESCEND),
            cursor_delta=self._cursor_delta,
            wheel=self._wheel,
            looking=BUTTON_LOOK in self.pressed_buttons,
        )
        self._cursor_delta = (0.0, 0.0)
        self._wheel = 0.0
        return out
