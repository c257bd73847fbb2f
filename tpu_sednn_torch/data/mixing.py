"""Noise mixing and synthetic corpus generation.

The reference builds its multi-condition set offline (TIMIT clean x 104-115
noise types x 7 SNRs, README.md:13-24).  Here mixing is a one-liner that can
run on device; the synthetic generators produce TIMIT-shaped material for
tests and benchmarks without shipping corpora.

Own copy of tpu_sednn/data/mixing.py (host numpy; the same bits from the
same inputs).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def mix_at_snr(clean: np.ndarray, noise: np.ndarray, snr_db: float,
               rng: np.random.Generator | None = None) -> np.ndarray:
    """clean + scaled noise at the given global-RMS SNR.

    noise is tiled/cropped (with a random offset when rng is given) to match
    the clean length.
    """
    clean = np.asarray(clean, np.float32)
    noise = np.asarray(noise, np.float32)
    n = len(clean)
    if len(noise) < n:
        noise = np.tile(noise, n // len(noise) + 1)
    off = int(rng.integers(0, len(noise) - n + 1)) if rng is not None and len(noise) > n else 0
    noise = noise[off : off + n]
    p_c = float(np.mean(clean**2)) + 1e-12
    p_n = float(np.mean(noise**2)) + 1e-12
    scale = np.sqrt(p_c / (p_n * 10.0 ** (snr_db / 10.0)))
    return (clean + scale * noise).astype(np.float32)


def _smooth(x: np.ndarray, n_win: int) -> np.ndarray:
    if n_win <= 1:
        return x
    k = np.ones(n_win, np.float32) / n_win
    return np.convolve(x, k, mode="same")


def _synth_speech_simple(rng: np.random.Generator, n_samples: int,
                         sr: int) -> np.ndarray:
    """Single-template harmonic signal (narrow pitch range, two fixed formant
    bands, no segmental structure): easy to learn at toy scale, used by unit
    tests that assert the training machinery converges quickly."""
    t = np.arange(n_samples, dtype=np.float32) / sr
    f0 = 110.0 + 40.0 * np.sin(2 * np.pi * 0.7 * t + rng.uniform(0, 2 * np.pi))
    phase = 2 * np.pi * np.cumsum(f0) / sr
    sig = np.zeros(n_samples, np.float32)
    n_harm = int(0.45 * sr / 150.0)
    fmt1 = 500.0 + 300.0 * np.sin(2 * np.pi * rng.uniform(0.3, 1.0) * t)
    fmt2 = 1800.0 + 700.0 * np.sin(2 * np.pi * rng.uniform(0.2, 0.8) * t + 1.0)
    for h in range(1, n_harm + 1):
        fh = h * 130.0
        res = (1.0 / (1.0 + ((fh - fmt1) / 300.0) ** 2)
               + 0.7 / (1.0 + ((fh - fmt2) / 400.0) ** 2) + 0.1)
        sig += (res / np.sqrt(h)) * np.sin(h * phase + rng.uniform(0, 2 * np.pi))
    env = 0.35 + 0.65 * np.abs(np.sin(2 * np.pi * rng.uniform(1.5, 3.5) * t))
    sig = sig * env
    burst_env = np.clip(np.sin(2 * np.pi * rng.uniform(0.8, 1.6) * t
                               + rng.uniform(0, 6)) - 0.8, 0, 1) * 5
    noise = np.diff(rng.standard_normal(n_samples), prepend=0.0)
    sig += 0.6 * burst_env * noise.astype(np.float32) * sig.std()
    sig = 0.3 * sig / (np.abs(sig).max() + 1e-9)
    return (sig + 5e-4 * rng.standard_normal(n_samples)).astype(np.float32)


def synth_speech(rng: np.random.Generator, n_samples: int, sr: int = 8000,
                 style: str = "rich") -> np.ndarray:
    """Speech-like synthetic utterance, built to match real-speech LPS
    statistics closely enough that models trained on it transfer to real
    recordings (the enh_wav_example demo clips):

    * per-utterance "speaker": pitch base drawn from the male/female range,
      with a slow prosodic contour plus a jitter random walk;
    * four formant resonances with independent slow trajectories (vowel
      transitions), evaluated at the TRUE time-varying harmonic frequencies
      h*f0(t), over a -6 dB/oct glottal+radiation source tilt;
    * segmental structure: voiced / fricative / silence states with
      phone-scale durations, 10 ms-smoothed transitions, syllabic amplitude
      modulation, and occasional plosive bursts at segment onsets.

    style="simple" selects the single-template generator (easy to learn at
    toy scale; what fast unit tests train against).
    """
    if style == "simple":
        return _synth_speech_simple(rng, n_samples, sr)
    t = np.arange(n_samples, dtype=np.float32) / sr
    # ---- voiced source: pitch track -------------------------------------
    f0_base = rng.uniform(85.0, 250.0)
    contour = (
        1.0
        + 0.16 * np.sin(2 * np.pi * rng.uniform(0.4, 1.2) * t + rng.uniform(0, 2 * np.pi))
        + 0.07 * np.sin(2 * np.pi * rng.uniform(1.5, 3.0) * t + rng.uniform(0, 2 * np.pi))
    )
    walk = np.cumsum(rng.standard_normal(n_samples).astype(np.float32))
    jitter = 1.0 + 0.02 * walk / (np.abs(walk).max() + 1e-9)
    f0 = (f0_base * contour * jitter).astype(np.float32)
    phase = (2 * np.pi * np.cumsum(f0) / sr).astype(np.float32)

    # ---- formant tracks (F1..F4 within 8 kHz-band speech ranges) --------
    def traj(lo: float, hi: float, r0: float, r1: float) -> np.ndarray:
        x = np.sin(2 * np.pi * rng.uniform(r0, r1) * t + rng.uniform(0, 2 * np.pi))
        x = x + 0.4 * np.sin(2 * np.pi * rng.uniform(r1, 2 * r1) * t + rng.uniform(0, 2 * np.pi))
        x = x / (np.abs(x).max() + 1e-9)
        return (lo + (hi - lo) * (0.5 + 0.5 * x)).astype(np.float32)

    top = 0.48 * sr
    fmts = [traj(280.0, 880.0, 0.5, 2.0), traj(850.0, min(2400.0, top), 0.4, 1.8),
            traj(2150.0, min(3200.0, top), 0.3, 1.2)]
    if top > 3400.0:
        fmts.append(traj(3100.0, min(3900.0, top), 0.2, 0.8))
    bws = (90.0, 130.0, 180.0, 240.0)
    amps = (1.0, 0.6, 0.3, 0.18)

    # ---- harmonics through the formant envelope (vectorized (H, n)) -----
    n_harm = max(3, int(top / float(f0.min())))
    h = np.arange(1, n_harm + 1, dtype=np.float32)[:, None]
    fh = h * f0[None, :]  # true harmonic frequencies
    env = np.full(fh.shape, 0.03, np.float32)
    for fm, bw, am in zip(fmts, bws, amps):
        env += am / (1.0 + ((fh - fm[None, :]) / bw) ** 2)
    env *= (fh < top)  # no energy above Nyquist guard band
    env /= h  # ~-6 dB/oct source+radiation tilt
    ph0 = rng.uniform(0, 2 * np.pi, (n_harm, 1)).astype(np.float32)
    voiced = np.sum(env * np.sin(h * phase[None, :] + ph0), axis=0)

    # ---- fricative source: formant-ish shaped high band -----------------
    wn = rng.standard_normal(n_samples).astype(np.float32)
    hp = np.diff(wn, prepend=np.float32(0.0))  # +6 dB/oct tilt
    fric = hp + 0.5 * _smooth(wn, 3)  # a little mid-band body

    # ---- segmental state machine: voiced / fricative / silence ----------
    voiced_env = np.zeros(n_samples, np.float32)
    fric_env = np.zeros(n_samples, np.float32)
    burst = np.zeros(n_samples, np.float32)
    # leading silence, like real recordings: it is what makes the NAT
    # noise estimate (mean of the first 6 frames, Interface.cc:776-779)
    # an actual noise estimate once noise is mixed in
    pos = int(rng.uniform(0.1, 0.25) * sr)
    while pos < n_samples:
        dur = int(rng.uniform(0.06, 0.35) * sr)
        state = rng.choice(("v", "f", "s"), p=(0.62, 0.23, 0.15))
        lvl = rng.uniform(0.5, 1.0)
        if state == "v":
            voiced_env[pos : pos + dur] = lvl
        elif state == "f":
            fric_env[pos : pos + dur] = lvl * 0.5
            if rng.uniform() < 0.4 and pos + 80 < n_samples:  # plosive onset
                blen = int(0.008 * sr)
                burst[pos : pos + blen] = rng.uniform(1.0, 2.5)
        pos += dur
    n10ms = max(1, int(0.01 * sr))
    voiced_env = _smooth(voiced_env, n10ms)
    fric_env = _smooth(fric_env, n10ms)
    # syllabic modulation on the voiced stream (3-7 Hz energy modulation,
    # the modulation band STOI listens to)
    syl = 0.45 + 0.55 * np.abs(np.sin(2 * np.pi * rng.uniform(1.5, 3.5) * t
                                      + rng.uniform(0, 2 * np.pi)))
    sig = voiced * voiced_env * syl
    vstd = float(sig.std()) + 1e-9
    sig = sig + (fric_env + burst) * fric * (0.35 * vstd / (float(fric.std()) + 1e-9))
    # guarantee audible content even for unlucky state draws
    if float(sig.std()) < 1e-6:
        sig = voiced * syl
    sig = 0.3 * sig / (np.abs(sig).max() + 1e-9)
    # recording-floor noise bed (~-55 dB re peak): real "clean" corpora have
    # mic/room noise, never digital zero — keeps silence LPS targets off the
    # log floor (log(1e-12)), which would otherwise dominate the regression
    sig = sig + 5e-4 * rng.standard_normal(n_samples).astype(np.float32)
    return sig.astype(np.float32)


#: the flagship training protocol's noise families; NoiseX-92-flavored
#: coverage of the stationary / tonal / impulsive / band-limited axes the
#: reference trains against (README.md:13-24: "104-115 noise types").
#: FROZEN at 7: every tracked training artifact (flagship gates, seed-jitter
#: runs, reverb variants) was produced with exactly this tuple — widening it
#: would silently change the protocol under reproduction runs.
NOISE_KINDS = ("white", "pink", "babble", "hum", "machinegun", "factory",
               "hfchannel")

#: round-5 widening (VERDICT r4 item 4): eight MORE families, used only as
#: held-out evaluation conditions — no tracked model trains on them — to
#: push the unseen-noise protocol toward the reference's 15 unseen NoiseX-92
#: types (the reference's README.md:22-24)
EXTRA_UNSEEN_NOISE_KINDS = ("siren", "traffic", "rain", "wind", "crowd",
                            "amtone", "jet", "car")
ALL_NOISE_KINDS = NOISE_KINDS + EXTRA_UNSEEN_NOISE_KINDS

#: the held-out families for the unseen-noise generalization protocol — the
#: reference evaluates on 15 noise types NEVER seen in training; training on
#: SEEN_NOISE_KINDS (5) and evaluating on all 15 yields a seen-vs-unseen gap
#: over 10 unseen families (recipes/multi_condition.py eval_noise_kinds)
UNSEEN_NOISE_KINDS = ("factory", "hfchannel") + EXTRA_UNSEEN_NOISE_KINDS
SEEN_NOISE_KINDS = tuple(k for k in NOISE_KINDS if k not in UNSEEN_NOISE_KINDS)


def synth_rir(rng: np.random.Generator, sr: int,
              rt60_s: float | None = None) -> np.ndarray:
    """Synthetic room impulse response: unit direct path + sparse early
    reflections (first ~50 ms) + dense exponentially-decaying late tail with
    the RT60 decay constant (energy falls 60 dB over rt60_s).

    The reference's corpus is real recorded audio — mildly reverberant by
    nature (the Forrest Gump demo clip audibly so, README.md:46-52); this is
    the corpus-realism rung that models it (VERDICT r3 item 4)."""
    rt60 = float(rng.uniform(0.1, 0.5)) if rt60_s is None else float(rt60_s)
    n = max(int(rt60 * sr), 8)
    t = np.arange(n, dtype=np.float32) / sr
    h = np.zeros(n, np.float32)
    h[0] = 1.0  # direct path
    # sparse early reflections: a handful of signed taps, 3-50 ms delay,
    # amplitude shrinking with delay (image-source flavor)
    for _ in range(int(rng.integers(4, 10))):
        d = int(rng.uniform(0.003, 0.05) * sr)
        if d < n:
            h[d] += rng.choice((-1.0, 1.0)) * rng.uniform(0.1, 0.5) * np.exp(-d / (0.02 * sr))
    # dense late tail: gaussian noise under the RT60 exponential envelope,
    # fading in after ~5 ms (before that the early reflections dominate)
    tau = rt60 / (3.0 * np.log(10.0))  # amplitude e-folding for 60 dB/rt60
    tail = rng.standard_normal(n).astype(np.float32) * np.exp(-t / tau)
    fade = np.clip((t - 0.005) / 0.01, 0.0, 1.0)
    h += 0.25 * tail * fade
    return h


def apply_reverb(x: np.ndarray, h: np.ndarray, wet: float = 1.0) -> np.ndarray:
    """Convolve with an RIR (same-length output) and dry/wet mix; the result
    is RMS-renormalized to the dry level so downstream SNR mixing is
    unaffected by the room gain.  FFT convolution: the direct product is
    O(n*len(h)) ~ 150M MACs for a 2 s 16 kHz utterance x 0.3 s RIR."""
    x = np.asarray(x, np.float32)
    h = np.asarray(h, np.float32)
    n_fft = 1 << int(np.ceil(np.log2(len(x) + len(h) - 1)))
    rev = np.fft.irfft(np.fft.rfft(x, n_fft) * np.fft.rfft(h, n_fft),
                       n_fft)[: len(x)].astype(np.float32)
    y = (1.0 - wet) * x + wet * rev
    rms_x = float(np.sqrt(np.mean(x**2))) + 1e-12
    rms_y = float(np.sqrt(np.mean(y**2))) + 1e-12
    return (y * (rms_x / rms_y)).astype(np.float32)


def synth_noise(rng: np.random.Generator, n_samples: int, kind: str = "white") -> np.ndarray:
    t = np.arange(n_samples)
    if kind == "white":
        x = rng.standard_normal(n_samples)
    elif kind == "pink":
        # -3 dB/octave via FFT shaping
        spec = np.fft.rfft(rng.standard_normal(n_samples))
        f = np.maximum(np.fft.rfftfreq(n_samples), 1.0 / n_samples)
        x = np.fft.irfft(spec / np.sqrt(f), n_samples)
    elif kind == "babble":
        x = sum(synth_speech(rng, n_samples) for _ in range(6))
    elif kind == "hum":
        # tonal machinery: fundamental + harmonics + a little broadband bed
        f0 = rng.uniform(60.0, 220.0)
        x = sum((1.0 / h) * np.sin(2 * np.pi * f0 * h * t / 8000.0
                                   + rng.uniform(0, 2 * np.pi))
                for h in range(1, 9))
        x = x + 0.15 * rng.standard_normal(n_samples)
    elif kind == "machinegun":
        # impulsive bursts over near-silence (NoiseX machine-gun shape)
        x = 0.02 * rng.standard_normal(n_samples)
        period = int(rng.uniform(0.18, 0.5) * 8000)
        blen = int(0.03 * 8000)
        for st in range(int(rng.uniform(0, period)), n_samples - blen, period):
            x[st : st + blen] += rng.standard_normal(blen) * np.hanning(blen) * 4.0
    elif kind == "factory":
        # pink bed + random clanks + slow amplitude modulation
        x = synth_noise(rng, n_samples, "pink").astype(np.float64)
        for _ in range(max(1, n_samples // 6000)):
            st = int(rng.integers(0, max(1, n_samples - 400)))
            x[st : st + 400] += rng.standard_normal(400) * np.hanning(400) * 0.6
        x = x * (1.0 + 0.4 * np.sin(2 * np.pi * rng.uniform(0.3, 2.0) * t / 8000.0))
    elif kind == "hfchannel":
        # high-pass-weighted noise (hf radio channel flavor)
        spec = np.fft.rfft(rng.standard_normal(n_samples))
        f = np.fft.rfftfreq(n_samples)
        x = np.fft.irfft(spec * (0.1 + f / (f.max() + 1e-12)), n_samples)
    elif kind == "siren":
        # swept tone: slow FM between two corner frequencies + 2nd harmonic
        lo, hi = rng.uniform(500.0, 700.0), rng.uniform(1100.0, 1500.0)
        sweep = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(0.25, 0.9) * t / 8000.0
                                   + rng.uniform(0, 2 * np.pi))
        f_inst = lo + (hi - lo) * sweep
        phase = 2 * np.pi * np.cumsum(f_inst) / 8000.0
        x = np.sin(phase) + 0.3 * np.sin(2 * phase) + 0.05 * rng.standard_normal(n_samples)
    elif kind == "traffic":
        # brown-ish rumble + passing-vehicle swells + occasional horn tones
        spec = np.fft.rfft(rng.standard_normal(n_samples))
        f = np.maximum(np.fft.rfftfreq(n_samples), 1.0 / n_samples)
        x = np.fft.irfft(spec / f, n_samples)  # -6 dB/oct
        x = x / (np.abs(x).max() + 1e-9)
        swell = 1.0 + 0.8 * np.abs(np.sin(2 * np.pi * rng.uniform(0.1, 0.4)
                                          * t / 8000.0 + rng.uniform(0, 6)))
        x = x * swell
        hlen = min(2400, n_samples)
        for _ in range(int(rng.integers(0, 3))):  # horns
            st = int(rng.integers(0, max(1, n_samples - hlen)))
            fh = rng.uniform(300.0, 600.0)
            seg = np.sin(2 * np.pi * fh * np.arange(hlen) / 8000.0) * np.hanning(hlen)
            x[st : st + hlen] += 0.5 * seg
    elif kind == "rain":
        # dense Poisson droplet impacts (high-passed clicks) over a hiss bed
        x = 0.3 * np.diff(rng.standard_normal(n_samples), prepend=0.0)
        n_drops = max(1, int(n_samples / 8000.0 * rng.uniform(300, 800)))
        starts = rng.integers(0, max(1, n_samples - 48), n_drops)
        kernel = np.diff(np.hanning(48), prepend=0.0) * rng.uniform(0.8, 1.2)
        for st in starts:
            x[st : st + 48] += kernel[: n_samples - st] * rng.uniform(0.3, 1.5)
    elif kind == "wind":
        # low-passed noise under slow gust modulation (smoothed random walk)
        spec = np.fft.rfft(rng.standard_normal(n_samples))
        f = np.fft.rfftfreq(n_samples, d=1.0 / 8000.0)
        x = np.fft.irfft(spec / (1.0 + (f / 400.0) ** 2), n_samples)
        gust = _smooth(np.abs(np.cumsum(rng.standard_normal(n_samples))),
                       min(2000, n_samples))
        x = x * (0.3 + gust / (gust.max() + 1e-9))
    elif kind == "crowd":
        # many distant talkers: denser than babble (20 sources; the
        # 20-voice sum itself is the diffuseness) plus a light sub-ms
        # smoothing and a noise bed
        x = sum(synth_speech(rng, n_samples) for _ in range(20)).astype(np.float64)
        x = _smooth(x, 5) + 0.1 * rng.standard_normal(n_samples)
    elif kind == "amtone":
        # amplitude-modulated tone complex (rotating-machinery whine)
        fc = rng.uniform(500.0, 2000.0)
        fm = rng.uniform(2.0, 20.0)
        am = 1.0 + rng.uniform(0.5, 0.95) * np.sin(2 * np.pi * fm * t / 8000.0
                                                   + rng.uniform(0, 2 * np.pi))
        x = am * (np.sin(2 * np.pi * fc * t / 8000.0)
                  + 0.4 * np.sin(2 * np.pi * 1.5 * fc * t / 8000.0
                                 + rng.uniform(0, 2 * np.pi)))
        x = x + 0.1 * rng.standard_normal(n_samples)
    elif kind == "jet":
        # broadband cockpit roar: flat bed + strong mid-band resonance + a
        # high tonal whine (buccaneer/f16 NoiseX flavor)
        spec = np.fft.rfft(rng.standard_normal(n_samples))
        f = np.fft.rfftfreq(n_samples, d=1.0 / 8000.0)
        fr = rng.uniform(800.0, 1600.0)
        shape = 0.4 + 1.5 / (1.0 + ((f - fr) / 300.0) ** 2)
        x = np.fft.irfft(spec * shape, n_samples)
        x = x / (np.abs(x).max() + 1e-9)
        fw = rng.uniform(2500.0, 3600.0)
        x = x + 0.25 * np.sin(2 * np.pi * fw * t / 8000.0 + rng.uniform(0, 6))
    elif kind == "car":
        # car interior: steep low-pass (-12 dB/oct above ~100 Hz) + engine
        # firing harmonics (volvo NoiseX flavor)
        spec = np.fft.rfft(rng.standard_normal(n_samples))
        f = np.fft.rfftfreq(n_samples, d=1.0 / 8000.0)
        x = np.fft.irfft(spec / (1.0 + (f / 100.0) ** 2), n_samples)
        x = x / (np.abs(x).max() + 1e-9)
        f0 = rng.uniform(30.0, 60.0)
        x = x + sum((0.3 / h) * np.sin(2 * np.pi * f0 * h * t / 8000.0
                                       + rng.uniform(0, 2 * np.pi))
                    for h in range(1, 5))
    else:
        raise ValueError(f"unknown noise kind {kind}")
    return (0.1 * x / (np.abs(x).max() + 1e-9)).astype(np.float32)


def synth_corpus(
    seed: int,
    n_utts: int,
    sr: int = 8000,
    min_s: float = 1.0,
    max_s: float = 3.0,
    snrs: Tuple[float, ...] = (0.0, 5.0, 10.0),
    noise_kinds: Tuple[str, ...] = ("white", "pink"),
    variants: int = 1,
    len_quantum_s: float = 0.5,
    style: str = "rich",
    reverb_prob: float = 0.0,
    rt60_range: Tuple[float, float] = (0.1, 0.5),
    wet_range: Tuple[float, float] = (0.4, 1.0),
) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """-> (clean_wavs, noisy_wavs): a multi-condition training corpus.

    variants: noisy mixes per clean utterance (the reference replicates each
    clean TIMIT utterance under many noise x SNR conditions, README.md:13-24);
    the clean list repeats accordingly, so zip(cleans, noisys) stays pairwise.
    len_quantum_s: utterance lengths snap to this grid so downstream jitted
    per-length programs (STFT featurization) compile for a handful of shapes
    instead of one per utterance.
    reverb_prob: per-utterance probability of convolving the SPEECH with a
    synthetic RIR (synth_rir; RT60 ~ U(rt60_range), dry/wet ~ U(wet_range))
    BEFORE mixing — the reverberant speech is then both the mixing source and
    the training target, i.e. the task stays denoise-the-recording (the
    reference's "clean" corpus is real, mildly reverberant recordings), not
    dereverberation.
    """
    rng = np.random.default_rng(seed)
    cleans, noisys = [], []
    q = max(int(len_quantum_s * sr), 1)
    for _ in range(n_utts):
        n = int(rng.uniform(min_s, max_s) * sr)
        n = max(q, (n // q) * q)
        c = synth_speech(rng, n, sr, style=style)
        if reverb_prob > 0.0 and rng.uniform() < reverb_prob:
            h = synth_rir(rng, sr, rt60_s=float(rng.uniform(*rt60_range)))
            c = apply_reverb(c, h, wet=float(rng.uniform(*wet_range)))
        for _ in range(max(variants, 1)):
            nz = synth_noise(rng, n, str(rng.choice(noise_kinds)))
            snr = float(rng.choice(snrs))
            cleans.append(c)
            noisys.append(mix_at_snr(c, nz, snr, rng))
    return cleans, noisys
