"""Raw-media front ends, copied from the JAX package's `codecs/processors.py`:
a librosa-compatible STFT magnitude and a Slaney mel filterbank in numpy
(the ImageBind audio tower's), and the codec processors:

  * `ImageVAEProcessor` — resize and center crop → [-1, 1] array;
  * `AudioVAEProcessor` — waveform → the SpecVQGAN log-mel in [-1, 1].

Audio file decoding is not here: pass PCM float arrays in."""

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


# Reference mel normalization (extract_spec.py TRANSFORMS, applied after
# MelSpectrogram with spec_power=1): LowerThresh(1e-5) → Log10 →
# Multiply(20) → Subtract(20) → Add(100) → Divide(100) → Clip(0,1) →
# TrimSpec(860); extract_melspectrogram then maps [0,1] → [-1,1].
SPECVQGAN_SR = 22050
SPECVQGAN_NFFT = 1024
SPECVQGAN_HOP = 256
SPECVQGAN_FMIN = 125.0
SPECVQGAN_FMAX = 7600.0
SPECVQGAN_TRIM = 860


def specvqgan_mel(wav: np.ndarray, sr: int = SPECVQGAN_SR,
                  n_mels: int = 80, trim: int = SPECVQGAN_TRIM,
                  n_fft: int = SPECVQGAN_NFFT, hop: int = SPECVQGAN_HOP,
                  fmin: float = SPECVQGAN_FMIN,
                  fmax: float = SPECVQGAN_FMAX) -> np.ndarray:
    """The reference TRANSFORMS chain → (n_mels, ≤trim) in [0, 1]."""
    logmel = log_mel_spectrogram(
        wav, sr, n_fft=n_fft, hop=hop, n_mels=n_mels,
        fmin=fmin, fmax=fmax, spec_power=1.0,
    )
    x = (20.0 * logmel - 20.0 + 100.0) / 100.0
    return np.clip(x, 0.0, 1.0)[:, :trim].astype(np.float32)


class ImageVAEProcessor:
    """Image (path, bytes or array) → resized, center-cropped (size, size, 3)
    float32 array in [-1, 1]."""

    def __init__(self, size: int = 256):
        self.size = size

    def __call__(self, image) -> np.ndarray:
        from .image_io import load_image, resize_center_crop

        arr = load_image(image) if isinstance(image, (str, bytes)) else np.asarray(image)
        arr = resize_center_crop(arr, self.size)
        return arr.astype(np.float32) / 127.5 - 1.0


class AudioVAEProcessor:
    """Waveform → log-mel in [-1, 1] for the audio VQ codec: the TRANSFORMS
    chain over the clip's own duration, then 2·x − 1. `duration` pads or
    crops the waveform to that many seconds first."""

    def __init__(self, sample_rate: int = 22050, n_mels: int = 80,
                 duration: float | None = None):
        self.sample_rate = sample_rate
        self.n_mels = n_mels
        self.duration = duration

    def __call__(self, wav: np.ndarray) -> np.ndarray:
        wav = np.asarray(wav, np.float32)
        if self.duration is not None:
            target = int(self.sample_rate * self.duration)
            if len(wav) < target:
                wav = np.pad(wav, (0, target - len(wav)))
            wav = wav[:target]
        mel = specvqgan_mel(wav, self.sample_rate, n_mels=self.n_mels)
        return (2.0 * mel - 1.0).astype(np.float32)
