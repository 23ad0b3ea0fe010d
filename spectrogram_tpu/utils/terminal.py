"""Terminal live viewer: ANSI truecolor half-block rendering + hotkeys.

The reference's headline experience is a live scrolling GL spectrogram with
runtime device/palette dropdowns (reference src/main.rs:62-151).  This
framework is headless, so the equivalent surface is the terminal: each
character cell shows two vertical pixels via the upper-half-block glyph
(fg = top pixel, bg = bottom pixel, 24-bit color), the frequency axis runs
vertically, and time scrolls horizontally — at typical terminal sizes one
frame is a few hundred KB of escape codes at 20-30 Hz, far under a TTY's
throughput.

`render_ansi` is pure (testable without a TTY); `TerminalViewer` owns the
cursor/raw-mode lifecycle and the hotkey loop (p/P palette cycle, s source
cycle, q quit) — palette switches are pure state updates on the pipeline
(models/spectrogram.py set_palette), no recompile, exactly like flipping the
GObject `palette` property in the reference (main.rs:102-104).
"""

from __future__ import annotations

import sys
from typing import Optional

import numpy as np

ESC = "\x1b"
UPPER_HALF = "▀"


def downsample(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """[H, W, 3] u8 -> [out_h, out_w, 3] by strided picking (cheap; the
    spectrogram is smooth enough that area-averaging is not worth the host
    FLOPs at 20-30 Hz)."""
    h, w = img.shape[:2]
    ys = np.linspace(0, h - 1, out_h).round().astype(int)
    xs = np.linspace(0, w - 1, out_w).round().astype(int)
    return img[ys][:, xs]


def render_ansi(img: np.ndarray, cols: int, rows: int) -> str:
    """[H, W, 3] u8 RGB image -> ANSI truecolor half-block frame string of
    `rows` text rows by `cols` columns (each cell = 2 vertical pixels).
    The frame starts with cursor-home so successive frames overdraw in
    place (no scrollback spam)."""
    pix = downsample(img, rows * 2, cols)
    top = pix[0::2]
    bot = pix[1::2]
    out = [f"{ESC}[H"]
    for y in range(rows):
        line = []
        prev_fg = prev_bg = None
        for x in range(cols):
            fg = tuple(int(v) for v in top[y, x])
            bg = tuple(int(v) for v in bot[y, x])
            codes = []
            if fg != prev_fg:
                codes.append(f"38;2;{fg[0]};{fg[1]};{fg[2]}")
                prev_fg = fg
            if bg != prev_bg:
                codes.append(f"48;2;{bg[0]};{bg[1]};{bg[2]}")
                prev_bg = bg
            if codes:
                line.append(f"{ESC}[{';'.join(codes)}m")
            line.append(UPPER_HALF)
        line.append(f"{ESC}[0m")
        out.append("".join(line) + "\n")
    return "".join(out)


class TerminalViewer:
    """Raw-mode terminal frame sink with non-blocking hotkeys.

    Usage:
        with TerminalViewer() as tv:
            while ...:
                tv.draw(rgb, status="palette: Magma")
                for key in tv.keys():
                    ...
    Falls back to a no-op (draw() swallows frames, keys() yields nothing)
    when stdout is not a TTY, so the same loop runs under tests/CI.
    """

    def __init__(self, cols: Optional[int] = None, rows: Optional[int] = None,
                 stream=None):
        self.stream = stream or sys.stdout
        self.is_tty = hasattr(self.stream, "isatty") and self.stream.isatty()
        size = None
        if cols is None or rows is None:
            try:
                import shutil

                size = shutil.get_terminal_size()
            except OSError:  # pragma: no cover
                pass
        self.cols = cols or (size.columns if size else 100)
        self.rows = rows or max((size.lines if size else 32) - 2, 8)
        self._old_termios = None

    def __enter__(self):
        if self.is_tty:
            import termios
            import tty

            fd = sys.stdin.fileno()
            self._old_termios = termios.tcgetattr(fd)
            tty.setcbreak(fd)
            self.stream.write(f"{ESC}[2J{ESC}[?25l")  # clear + hide cursor
        return self

    def __exit__(self, *exc):
        if self.is_tty:
            import termios

            termios.tcsetattr(
                sys.stdin.fileno(), termios.TCSADRAIN, self._old_termios
            )
            self.stream.write(f"{ESC}[0m{ESC}[?25h\n")  # restore
            self.stream.flush()
        return False

    def draw(self, img: np.ndarray, status: str = "") -> None:
        if not self.is_tty:
            return
        frame = render_ansi(img, self.cols, self.rows)
        if status:
            frame += f"{ESC}[0m{status[: self.cols]}{ESC}[K"
        self.stream.write(frame)
        self.stream.flush()

    def keys(self):
        """Drain pending keypresses (non-blocking)."""
        if not self.is_tty:
            return
        import select

        while select.select([sys.stdin], [], [], 0)[0]:
            ch = sys.stdin.read(1)
            if not ch:
                return
            yield ch
