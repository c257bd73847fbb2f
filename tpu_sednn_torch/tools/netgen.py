"""Network generation / widening tools — a copy of tpu_sednn/tools/netgen.py
(host numpy; the port imports nothing of the JAX package).

Equivalents of the reference's offline weight toolchain
(toolbox/weights/gen_rand_net/):

* `gen_rand_net`  — Gen_rand_net.cpp:84-101: uniform random weights with
  fan-in (flag 0: U(+-beta/sqrt(n_in))) or Glorot (flag 1:
  U(+-beta*sqrt(6)/sqrt(n_in+n_out))) range, zero biases, written in `.wts`
  layout.
* `extend_net`    — Extend_rand_net.cpp:255-284: grow each layer to
  ori+add units; the old block is kept at W[:ori_prev, :ori_cur], new
  rows/columns get Glorot randoms at the NEW sizes, new biases are zero.
* `extend_net_boost` — Extend_rand_net_boost.cpp:193-218: same geometry but
  new weights/biases are RESAMPLED uniformly from the layer's existing
  weight/bias pool (Net2Net-flavored widening).

All three operate on in-memory (weights, biases) lists in this framework's
(prev, cur) convention — which is also the file layout the reference's
extend tools index by (`weights[m*cur + n]`, m=prev, n=cur).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

Net = Tuple[List[np.ndarray], List[np.ndarray]]


def gen_rand_net(
    layersizes: Sequence[int],
    flag: int = 1,
    beta: float = 1.0,
    seed: int = 0,
) -> Net:
    rng = np.random.default_rng(seed)
    ws, bs = [], []
    for i in range(1, len(layersizes)):
        n_in, n_out = layersizes[i - 1], layersizes[i]
        if flag:
            rng_range = beta * np.sqrt(6.0) / np.sqrt(n_in + n_out)
        else:
            rng_range = beta / np.sqrt(n_in)
        ws.append(rng.uniform(-rng_range, rng_range, (n_in, n_out)).astype(np.float32))
        bs.append(np.zeros(n_out, np.float32))
    return ws, bs


def _check_extend(ori: Sequence[int], add: Sequence[int]):
    if len(ori) != len(add):
        raise ValueError("ori_layersizes and add_layersizes length mismatch")
    if add[0] != 0 or add[-1] != 0:
        raise ValueError("input/output layer sizes cannot grow (reference semantics)")


def extend_net(
    weights: Sequence[np.ndarray],
    biases: Sequence[np.ndarray],
    add_layersizes: Sequence[int],
    beta: float = 1.0,
    seed: int = 0,
) -> Net:
    ori = [weights[0].shape[0]] + [w.shape[1] for w in weights]
    _check_extend(ori, add_layersizes)
    new_sizes = [o + a for o, a in zip(ori, add_layersizes)]
    rng = np.random.default_rng(seed)
    ws, bs = [], []
    for i in range(1, len(new_sizes)):
        prev, cur = new_sizes[i - 1], new_sizes[i]
        o_prev, o_cur = ori[i - 1], ori[i]
        rng_range = beta * np.sqrt(6.0) / np.sqrt(prev + cur)
        w = np.zeros((prev, cur), np.float32)
        w[:o_prev, :o_cur] = weights[i - 1]
        # all rows x new columns, then new rows x old columns
        w[:, o_cur:] = rng.uniform(-rng_range, rng_range, (prev, cur - o_cur))
        w[o_prev:, :o_cur] = rng.uniform(-rng_range, rng_range, (prev - o_prev, o_cur))
        b = np.zeros(cur, np.float32)
        b[:o_cur] = biases[i - 1]
        ws.append(w)
        bs.append(b)
    return ws, bs


def extend_net_boost(
    weights: Sequence[np.ndarray],
    biases: Sequence[np.ndarray],
    add_layersizes: Sequence[int],
    seed: int = 0,
) -> Net:
    ori = [weights[0].shape[0]] + [w.shape[1] for w in weights]
    _check_extend(ori, add_layersizes)
    new_sizes = [o + a for o, a in zip(ori, add_layersizes)]
    rng = np.random.default_rng(seed)
    ws, bs = [], []
    for i in range(1, len(new_sizes)):
        prev, cur = new_sizes[i - 1], new_sizes[i]
        o_prev, o_cur = ori[i - 1], ori[i]
        pool_w = np.asarray(weights[i - 1], np.float32).ravel()
        pool_b = np.asarray(biases[i - 1], np.float32)
        w = np.zeros((prev, cur), np.float32)
        w[:o_prev, :o_cur] = weights[i - 1]
        w[:, o_cur:] = rng.choice(pool_w, size=(prev, cur - o_cur))
        w[o_prev:, :o_cur] = rng.choice(pool_w, size=(prev - o_prev, o_cur))
        b = np.zeros(cur, np.float32)
        b[:o_cur] = pool_b
        b[o_cur:] = rng.choice(pool_b, size=cur - o_cur)
        ws.append(w)
        bs.append(b)
    return ws, bs


def main(argv=None) -> int:
    """CLI matching Gen_rand_net's positional convention:

        python -m tpu_sednn_torch.tools.netgen numlayers s0 s1 ... out.wts flag beta
    (Gen_rand_net.cpp:64-81; out_dir argument dropped — it only wrote debug files.)
    """
    import sys

    from tpu_sednn_torch.io.wts import save_wts

    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 4:
        print("usage: numlayers layersizes... out.wts flag beta", file=sys.stderr)
        return 1
    numlayers = int(argv[0])
    sizes = [int(v) for v in argv[1 : 1 + numlayers]]
    out, flag, beta = argv[1 + numlayers], int(argv[2 + numlayers]), float(argv[3 + numlayers])
    ws, bs = gen_rand_net(sizes, flag=flag, beta=beta)
    save_wts(out, ws, bs)
    print(f"wrote {out}: layers {sizes}, flag={flag}, beta={beta}")
    return 0


def extend_main(argv=None) -> int:
    """CLI matching Extend_rand_net[_boost]'s positional convention:

        python -m tpu_sednn_torch.tools.netgen extend \\
            numlayers beta ori_s0..ori_sN add_s0..add_sN in.wts out.wts [--boost]

    (Extend_rand_net.cpp:262 usage string: "numlayers beta ori_layersizes
    add_layersizes in_pfile out_pfile"; --boost selects the
    Extend_rand_net_boost resampling variant.)
    """
    import sys

    from tpu_sednn_torch.io.wts import load_wts, save_wts

    argv = list(argv if argv is not None else sys.argv[1:])
    boost = "--boost" in argv
    if boost:
        argv.remove("--boost")
    usage = ("usage: numlayers beta ori_layersizes... add_layersizes... "
             "in.wts out.wts [--boost]")
    if len(argv) < 4:
        print(usage, file=sys.stderr)
        return 1
    numlayers = int(argv[0])
    if len(argv) != 4 + 2 * numlayers:  # 2 + 2*numlayers sizes + 2 paths
        print(f"{usage}\nexpected {4 + 2 * numlayers} args for "
              f"numlayers={numlayers}, got {len(argv)}", file=sys.stderr)
        return 1
    beta = float(argv[1])
    ori = [int(v) for v in argv[2 : 2 + numlayers]]
    add = [int(v) for v in argv[2 + numlayers : 2 + 2 * numlayers]]
    in_wts, out_wts = argv[2 + 2 * numlayers], argv[3 + 2 * numlayers]
    ws, bs = load_wts(in_wts, layersizes=ori)
    if boost:
        ws, bs = extend_net_boost(ws, bs, add)
    else:
        ws, bs = extend_net(ws, bs, add, beta=beta)
    save_wts(out_wts, ws, bs)
    new_sizes = [o + a for o, a in zip(ori, add)]
    print(f"wrote {out_wts}: {ori} -> {new_sizes}"
          + (" (boost resampling)" if boost else f" (glorot, beta={beta})"))
    return 0


if __name__ == "__main__":
    import sys

    if len(sys.argv) > 1 and sys.argv[1] == "extend":
        sys.exit(extend_main(sys.argv[2:]))
    sys.exit(main())
