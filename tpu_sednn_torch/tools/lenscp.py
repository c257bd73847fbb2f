"""`.len` file emitter, the GetLenScp.exe equivalent — a copy of
tpu_sednn/tools/lenscp.py (the port imports nothing of the JAX package).

The reference pfile pipeline needs a text file with one frame count per
feature file, in scp order, to drive feacat's sentence ranges
(the reference's how_to_get_pfile.txt:6-12: "prepare '.len' TXT file (the
frame number of each '.lsp' file, one number on each line)").

    python -m tpu_sednn_torch.tools.lenscp in.scp out.len [--le] [--wav [--sr N]]

Default input is big-endian HTK feature files (only the 12-byte header is
read); --le reads little-endian HTK; --wav counts STFT frames of wav files
at the canonical 32 ms window / 16 ms hop for their sample rate.
"""

from __future__ import annotations

import struct
import sys


def htk_num_frames(path: str, big_endian: bool = True) -> int:
    """Frame count from an HTK header (int32 nSamples, read_htk_fea.m:13)."""
    with open(path, "rb") as f:
        raw = f.read(4)
    if len(raw) != 4:
        raise IOError(f"{path}: truncated HTK header")
    return struct.unpack(">i" if big_endian else "<i", raw)[0]


def wav_num_frames(path: str, sample_rate: int | None = None) -> int:
    from tpu_sednn_torch.dsp.stft import StftConfig
    from tpu_sednn_torch.io.wav import read_wav

    x, sr = read_wav(path)
    cfg = StftConfig.for_rate(sample_rate or sr)
    if len(x) < cfg.win_len:
        return 0
    return 1 + (len(x) - cfg.win_len) // cfg.hop


def main(argv=None) -> int:
    argv = list(argv if argv is not None else sys.argv[1:])
    le = "--le" in argv
    wav = "--wav" in argv
    sr = None
    for flag in ("--le", "--wav"):
        if flag in argv:
            argv.remove(flag)
    if "--sr" in argv:
        i = argv.index("--sr")
        sr = int(argv[i + 1])
        del argv[i : i + 2]
    if len(argv) != 2:
        print("usage: lenscp in.scp out.len [--le] [--wav [--sr N]]",
              file=sys.stderr)
        return 1
    scp, out = argv
    counts = []
    with open(scp) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            path = line.split()[0]
            counts.append(wav_num_frames(path, sr) if wav
                          else htk_num_frames(path, big_endian=not le))
    with open(out, "w") as f:
        for c in counts:
            f.write(f"{c}\n")
    print(f"wrote {out}: {len(counts)} entries")
    return 0


if __name__ == "__main__":
    sys.exit(main())
