"""Diarization timeline viewer (copy of the JAX package's
``infer_utils/viewer.py``; reference ``ppvector/infer_utils/viewer.py``).

Renders per-speaker segment bars with matplotlib. ``draw(save_path)`` works
headless; ``show()`` opens the interactive figure with space = play/pause
and click = seek, when a display and audio device exist.

matplotlib is imported by ``draw`` and ``show``, not by this module: the
package imports on a host without matplotlib, and drawing there raises
``ImportError``.
"""

from ..utils.logger import logger

__all__ = ["PlotSpeaker"]


class PlotSpeaker:
    def __init__(self, results, audio_path=None, title="speaker diarization"):
        """``results``: list of {speaker, start, end} dicts."""
        self.results = results
        self.audio_path = audio_path
        self.title = title
        self.player = None
        if audio_path is not None:
            try:
                from .player import AudioPlayer
                self.player = AudioPlayer(audio_path)
            except Exception as e:  # noqa: BLE001 - the plot works silent
                logger.warning(f"audio player unavailable: {e}")

    def _render(self, plt):
        speakers = sorted({r["speaker"] for r in self.results},
                          key=lambda s: str(s))
        ymap = {s: i for i, s in enumerate(speakers)}
        fig, ax = plt.subplots(figsize=(12, 0.8 * len(speakers) + 2))
        cmap = plt.get_cmap("tab10")
        for r in self.results:
            y = ymap[r["speaker"]]
            ax.barh(y, r["end"] - r["start"], left=r["start"], height=0.6,
                    color=cmap(y % 10), edgecolor="black", linewidth=0.3)
        ax.set_yticks(range(len(speakers)))
        ax.set_yticklabels([str(s) for s in speakers])
        ax.set_xlabel("time (s)")
        ax.set_title(self.title)
        ax.grid(True, axis="x", alpha=0.3)
        return fig, ax

    def draw(self, save_path=None):
        """Headless render to file."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, _ = self._render(plt)
        if save_path:
            import os
            os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
            fig.savefig(save_path, bbox_inches="tight", dpi=120)
            logger.info(f"diarization plot saved: {save_path}")
        return fig

    def show(self):
        """Interactive display: space toggles playback, click seeks."""
        import matplotlib.pyplot as plt
        fig, ax = self._render(plt)
        cursor = ax.axvline(0.0, color="red")

        def on_key(event):
            if event.key == " " and self.player is not None:
                if self.player.playing:
                    self.player.pause()
                else:
                    self.player.play()

        def on_click(event):
            if event.xdata is not None and self.player is not None:
                self.player.seek(event.xdata)
                cursor.set_xdata([event.xdata])
                fig.canvas.draw_idle()

        def on_timer(_=None):
            if self.player is not None and self.player.playing:
                cursor.set_xdata([self.player.current_time()])
                fig.canvas.draw_idle()

        fig.canvas.mpl_connect("key_press_event", on_key)
        fig.canvas.mpl_connect("button_press_event", on_click)
        timer = fig.canvas.new_timer(interval=200)
        timer.add_callback(on_timer)
        timer.start()
        plt.show()
