"""PyTorch port, the diarization viewer and player
(``infer_utils/viewer.py``, ``infer_utils/player.py``) against the JAX
package's.

``PlotSpeaker.draw`` writes a PNG of more than 1000 bytes (as
``tests/test_viewer.py`` checks for JAX); ``_render`` draws the same bars
as JAX's, bar for bar (x, width, y, face colour, exactly), for integer and
string speakers, one speaker and no segments, with the same tick labels;
the package imports with matplotlib hidden and ``draw`` then raises
``ImportError``. ``AudioPlayer`` decodes ``dataset/a_1.wav`` to JAX's
samples, rate and duration (exactly); ``seek`` clips to ``[0, duration]``;
the silent clock (no audio device) advances while playing and stops on
``pause``."""

import os
import subprocess
import sys
import time

import matplotlib
import numpy as np
import pytest

import torch_jax_native  # noqa: F401 (JAX's native library, locked)
from torch_jax_native import require_jax_native
from voiceprintrecognition_paddlepaddle_torch.infer_utils.player import \
    AudioPlayer
from voiceprintrecognition_paddlepaddle_torch.infer_utils.viewer import \
    PlotSpeaker
from voiceprintrecognition_paddlepaddle_tpu.infer_utils.player import \
    AudioPlayer as JaxAudioPlayer
from voiceprintrecognition_paddlepaddle_tpu.infer_utils.viewer import \
    PlotSpeaker as JaxPlotSpeaker

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
A_1 = os.path.join(ROOT, "dataset", "a_1.wav")

RESULTS = {
    "int_speakers": [{"speaker": 0, "start": 0.0, "end": 2.5},
                     {"speaker": 1, "start": 2.5, "end": 4.0},
                     {"speaker": 0, "start": 4.0, "end": 6.0},
                     {"speaker": 2, "start": 6.25, "end": 7.5}],
    "string_speakers": [{"speaker": "bob", "start": 0.0, "end": 1.5},
                        {"speaker": "alice", "start": 1.5, "end": 3.0},
                        {"speaker": "stranger2", "start": 3.75, "end": 5.0},
                        {"speaker": "alice", "start": 5.0, "end": 9.0}],
    "one_speaker": [{"speaker": "alice", "start": 0.5, "end": 1.25}],
    "empty": [],
}


def test_draw_writes_a_png(tmp_path):
    out = str(tmp_path / "plots" / "diar.png")
    PlotSpeaker(RESULTS["int_speakers"]).draw(out)
    assert os.path.exists(out) and os.path.getsize(out) > 1000


def _bars(viewer_cls, results):
    fig, ax = viewer_cls(results)._render(plt)
    try:
        bars = [(p.get_x(), p.get_width(), p.get_y(), p.get_height(),
                 tuple(p.get_facecolor())) for p in ax.patches]
        ticks = [t.get_text() for t in ax.get_yticklabels()]
        return bars, ticks, ax.get_title(), ax.get_xlabel()
    finally:
        plt.close(fig)


@pytest.mark.parametrize("case", sorted(RESULTS))
def test_render_draws_jax_bars(case):
    ours = _bars(PlotSpeaker, RESULTS[case])
    theirs = _bars(JaxPlotSpeaker, RESULTS[case])
    assert len(ours[0]) == len(RESULTS[case])
    assert ours == theirs


def test_package_imports_without_matplotlib():
    """matplotlib is imported by draw and show only: with it hidden the
    package and the viewer import, and draw raises ImportError naming it
    (in a child process, so this process's modules stay as they are)."""
    code = (
        "import sys\n"
        "sys.modules['matplotlib'] = None\n"
        "import voiceprintrecognition_paddlepaddle_torch.infer_utils\n"
        "from voiceprintrecognition_paddlepaddle_torch.infer_utils import "
        "player, viewer\n"
        "try:\n"
        "    viewer.PlotSpeaker([{'speaker': 0, 'start': 0.0, 'end': 1.0}])"
        ".draw()\n"
        "except ImportError as e:\n"
        "    print('ImportError:', e)\n")
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.startswith("ImportError:") and \
        "matplotlib" in proc.stdout, proc.stdout


def test_player_decodes_like_jax():
    require_jax_native()
    ours, theirs = AudioPlayer(A_1), JaxAudioPlayer(A_1)
    np.testing.assert_array_equal(ours.samples, theirs.samples)
    assert ours.sample_rate == theirs.sample_rate == 16000
    assert ours.duration == theirs.duration
    assert ours.current_time() == 0.0 and not ours.playing


def test_seek_clips_to_the_clip():
    player = AudioPlayer(A_1)
    for want, got in ((-1.0, 0.0), (1.5, 1.5),
                      (1e9, player.duration), (player.duration, player.duration)):
        player.seek(want)
        assert player.current_time() == got


def test_silent_clock_advances_and_pauses():
    player = AudioPlayer(A_1)
    player._speaker = None      # the silent clock, with or without a device
    player.seek(1.0)
    player.play()
    try:
        deadline = time.time() + 10
        while player.current_time() < 1.2 and time.time() < deadline:
            time.sleep(0.02)
        assert player.current_time() >= 1.2 and player.playing
    finally:
        player.pause()
    player._thread.join(timeout=5)
    assert not player._thread.is_alive() and not player.playing
    pos = player.current_time()
    time.sleep(0.2)
    assert player.current_time() == pos
