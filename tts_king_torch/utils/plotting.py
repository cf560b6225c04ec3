"""Mel-spectrogram plots with pitch/energy overlays (tools.plot_mel
equivalent, fs_two/utils/tools.py:277-329).

Port of tts_king_tpu/utils/plotting.py. matplotlib is imported when a plot
is drawn, not with this module: a machine without it still trains and
synthesizes, and ``matplotlib_available`` tells the callers whether to
draw.
"""

import numpy as np


def matplotlib_available() -> bool:
    """True where matplotlib imports (with the Agg backend)."""
    try:
        import matplotlib

        matplotlib.use("Agg")
    except ImportError:
        return False
    return True


def plot_mel(data, stats, titles=None):
    """data: list of (mel[n_mels, T], pitch[T], energy[T]); stats:
    [pitch_min, pitch_max, pitch_mean, pitch_std, energy_min, energy_max].
    Raises ImportError without matplotlib."""
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    fig, axes = plt.subplots(len(data), 1, squeeze=False)
    titles = titles or [None] * len(data)
    pitch_min, pitch_max, pitch_mean, pitch_std, energy_min, energy_max = stats
    pitch_max_hz = pitch_max * pitch_std + pitch_mean

    for i, (mel, pitch, energy) in enumerate(data):
        mel = np.asarray(mel)
        ax = axes[i][0]
        ax.imshow(mel, origin="lower", aspect="auto")
        ax.set_ylim(0, mel.shape[0])
        if titles[i]:
            ax.set_title(titles[i], fontsize="medium")
        ax.tick_params(labelsize="x-small", left=False, labelleft=False)

        ax1 = fig.add_axes(ax.get_position(), anchor="W")
        ax1.set_facecolor("None")
        ax1.plot(np.asarray(pitch) * pitch_std + pitch_mean, color="tomato")
        ax1.set_xlim(0, mel.shape[1])
        ax1.set_ylim(0, pitch_max_hz)
        ax1.set_ylabel("F0", color="tomato")
        ax1.tick_params(labelsize="x-small", colors="tomato", bottom=False,
                        labelbottom=False)

        ax2 = fig.add_axes(ax.get_position(), anchor="W")
        ax2.set_facecolor("None")
        ax2.plot(np.asarray(energy), color="darkviolet")
        ax2.set_xlim(0, mel.shape[1])
        ax2.set_ylim(energy_min, energy_max)
        ax2.set_ylabel("Energy", color="darkviolet")
        ax2.yaxis.set_label_position("right")
        ax2.tick_params(labelsize="x-small", colors="darkviolet",
                        bottom=False, labelbottom=False, left=False,
                        labelleft=False, right=True, labelright=True)
    return fig


def save_plot(fig, path):
    """Write ``fig`` to ``path`` and free it."""
    from matplotlib import pyplot as plt

    fig.savefig(path)
    plt.close(fig)
