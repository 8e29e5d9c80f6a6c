"""Audio front end for the ImageBind audio tower: a librosa-compatible
STFT magnitude and a Slaney mel filterbank in numpy, copied from the JAX
package's `codecs/processors.py` (the rest of that module, the codec
processors, comes with the codecs)."""

from __future__ import annotations

import numpy as np


def hann_window(n: int) -> np.ndarray:
    return 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / n)


def mel_filterbank(
    sr: int, n_fft: int, n_mels: int, fmin: float = 0.0, fmax: float | None = None
) -> np.ndarray:
    """Slaney-style mel filterbank (librosa-compatible shapes)."""
    fmax = fmax or sr / 2

    def hz_to_mel(f):
        f = np.asarray(f, np.float64)
        mel = 3 * f / 200.0
        log_region = f >= 1000
        mel = np.where(
            log_region, 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / (np.log(6.4) / 27.0), mel
        )
        return mel

    def mel_to_hz(m):
        m = np.asarray(m, np.float64)
        f = 200.0 * m / 3.0
        log_region = m >= 15.0
        f = np.where(log_region, 1000.0 * np.exp((np.log(6.4) / 27.0) * (m - 15.0)), f)
        return f

    mels = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    freqs = mel_to_hz(mels)
    fft_freqs = np.linspace(0, sr / 2, n_fft // 2 + 1)
    weights = np.zeros((n_mels, n_fft // 2 + 1))
    for i in range(n_mels):
        lower = (fft_freqs - freqs[i]) / max(freqs[i + 1] - freqs[i], 1e-10)
        upper = (freqs[i + 2] - fft_freqs) / max(freqs[i + 2] - freqs[i + 1], 1e-10)
        weights[i] = np.maximum(0, np.minimum(lower, upper))
    enorm = 2.0 / (freqs[2 : n_mels + 2] - freqs[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


def stft_magnitude(
    wav: np.ndarray, n_fft: int, hop: int, power: float = 1.0
) -> np.ndarray:
    """librosa.stft-compatible magnitude**power spectrogram:
    center=True reflect padding, periodic hann window.
    Returns (n_fft//2+1, frames)."""
    win = hann_window(n_fft)
    pad = n_fft // 2
    wav = np.pad(wav, (pad, pad), mode="reflect")
    n_frames = 1 + (len(wav) - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = wav[idx] * win[None, :]
    return (np.abs(np.fft.rfft(frames, axis=1)) ** power).T


def log_mel_spectrogram(
    wav: np.ndarray,
    sr: int = 22050,
    n_fft: int = 1024,
    hop: int = 256,
    n_mels: int = 80,
    fmin: float = 0.0,
    fmax: float | None = None,
    spec_power: float = 2.0,
) -> np.ndarray:
    """(T,) waveform → (n_mels, frames) log10-mel. The SpecVQGAN codec
    frontend calls this with fmin=125, fmax=7600, spec_power=1
    (reference extract_spec.py TRANSFORMS)."""
    spec = stft_magnitude(wav, n_fft, hop, spec_power)
    mel = mel_filterbank(sr, n_fft, n_mels, fmin=fmin, fmax=fmax) @ spec
    return np.log10(np.maximum(mel, 1e-5)).astype(np.float32)
