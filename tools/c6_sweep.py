"""C6 on one CUDA card: how far the port's tensor-core products
(or_gym_inventory_torch/csrc/mma_tf32.cuh, under the tile kernels K4-K6,
K10-K12, K18-K20 and the LSTM kernels K22-K24) miss float32 accuracy on
actors over raw observations, where that comes from, and what it costs.

Three parts, each on by default:

- ``--probe``: tools/c6_probe.cu, one dense layer on the tensor cores
  (mma_layer_tiles of the package's csrc/mma_tf32.cuh, and candidate
  k-steps on the same split and product: ``SCHEMES``), built here into the
  ignored ``build/c6_sweep/``. First the accumulator alone: one mma.sync a
  k-step on raw TF32 operands against the exact sum (float64), rounded to
  nearest and toward zero. Then each layer of C6's two raw actors
  (``chip_smoke.c6_actors``: PPO's initial actor, the all-normal Gaussian
  actor) on each family's real observations (those K4, K10 and K18 saw
  under the actor, PROBE_COLUMNS of them), and LSTM-256's gate product on
  K24's: each scheme's error against float64, per unit of sum |W| |x| +
  |b|, beside the float32 product's on the card and on the CPU and the
  NumPy emulation of the first design (tests/test_torch_lstm_mma_plan.py
  ``_mma_3xtf32``, IEEE float32 sums of each k-step's products).
- ``--shares``: the free-running lane shares (``chip_smoke.lane_share``,
  rtol=1e-4 atol=1e-2 over a lane's whole episode): K5, K11 and K19 at
  C6_LANES x C6_EPISODES deterministic and stochastic, K4, K10 and K18's
  rewards at C6_LANES x the horizon, under both actors, and K24 under
  LSTM-256; each the kernel against plain on the card, and plain on the
  card against plain on the CPU (the same seed and actor).
- ``--turns``: the 12 kernels on the arithmetic at the defaults (K4-K6,
  K10-K12, K18-K20 by tools/actor_sweep.py's cases, K22-K24 by
  tools/lstm_caps_sweep.py's) in turns parent, package, package, parent
  against ``tools/c6_parent/``, the sources that include csrc/mma_tf32.cuh
  as they were before C6's repair (built against the package's other
  headers); their outputs differ (other arithmetic), so the max |diff| is
  recorded, not raised.

Every line carries the card's name and power limit (``nvidia-smi``); a JSON
line of all of it ends the output.

    python3 tools/c6_sweep.py [--probe] [--shares] [--turns] [--rounds 3]

Without a CUDA card it exits 1.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))
sys.path.insert(0, str(ROOT / "tests"))   # the emulation, test_torch_lstm_mma_plan._mma_3xtf32

PARENT = ROOT / "tools" / "c6_parent"
PARENT_SOURCES = ("net_policy", "im_policy", "nv_policy", "im_lstm")
SCHEMES = {0: "package: both in 3, fresh 6", 1: "running 3 (first design)", 2: "fresh 3",
           3: "fresh 3, big first", 4: "running 4", 5: "fresh 4", 6: "fresh 3 / 2 k-steps",
           7: "small apart", 8: "one TF32", 9: "A in 3, fresh 5"}
# the schemes run through a whole actor (``forward_report``)
FORWARD_SCHEMES = (0, 1, 2, 5, 9)
PROBE_COLUMNS = 16_384
EMULATED_COLUMNS = 2_048
TILE_KERNELS = ("K4", "K5", "K6", "K10", "K11", "K12", "K18", "K19", "K20")
LSTM_KERNELS = ("K22", "K23", "K24")


def _out_dir() -> pathlib.Path:
    from or_gym_inventory_torch.ops import _build
    d = _build.BUILD_DIR / "c6_sweep"
    d.mkdir(parents=True, exist_ok=True)
    return d


def start_builds(turns: bool) -> dict:
    """Start nvcc on the probe and, with ``turns``, on the parent's four
    sources (its own headers first, then the package's). Returns {name:
    (library path, process)}."""
    from or_gym_inventory_torch.ops import _build
    jobs = {"probe": ROOT / "tools" / "c6_probe.cu"}
    if turns:
        jobs.update({stem: PARENT / f"{stem}.cu" for stem in PARENT_SOURCES})
    out = {}
    for name, src in jobs.items():
        so = _out_dir() / f"lib{name}_c6.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so),
               str(src)]
        out[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                          text=True))
    return out


def finish_builds(jobs: dict) -> tuple:
    """Wait for ``start_builds``' jobs; bind the probe and the parent's
    libraries (the package's signatures of their fixed-class entry points).
    Returns (probe library, {stem: parent library}, {name: ptxas lines})."""
    from or_gym_inventory_torch.ops import _build
    import chip_smoke as cs
    libs, logs = {}, {}
    for name, (so, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        logs[name] = cs.ptxas_entries(out)
        lib = ctypes.CDLL(str(so))
        if name == "probe":
            lib.c6_probe_layer.argtypes = [ctypes.c_void_p] * 4 + [
                ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
            lib.c6_probe_layer.restype = ctypes.c_int
        else:
            sigs = {fn: sig for fn, sig in _build.SIGNATURES[name].items()
                    if not fn.endswith(("_any", "_chain"))}
            for fn, (argtypes, restype) in {**sigs, **_build._SHARED}.items():
                getattr(lib, fn).argtypes, getattr(lib, fn).restype = list(argtypes), restype
        libs[name] = lib
    probe = libs.pop("probe")
    return probe, libs, logs


def probe_layer(lib, W, b, X, scheme: int):
    """W (out, in) @ X (in, N) + b on the card through c6_probe_layer under
    ``scheme`` (``SCHEMES``; -1 raw operands); float32 (out, N)."""
    import torch

    from or_gym_inventory_torch.ops import episode_kernels as ek
    dev = X.device
    frag, bp = ek._encoder_fragments(W.to(dev), b.to(dev))
    n_out, n_in = W.shape
    N = X.shape[1]
    Np = -(-N // 32) * 32
    Xp = torch.zeros((ek._pad8(n_in), Np), dtype=torch.float32, device=dev)
    Xp[:n_in, :N] = X
    Y = torch.empty((ek._pad16(n_out), Np), dtype=torch.float32, device=dev)
    rc = lib.c6_probe_layer(frag.data_ptr(), bp.data_ptr(), Xp.data_ptr(), Y.data_ptr(),
                            ek._pad16(n_out) // 16, ek._pad8(n_in) // 8, Np, scheme,
                            ek._stream(dev))
    if rc != 0:
        raise RuntimeError(f"c6_probe_layer scheme {scheme}: CUDA error {rc}")
    torch.cuda.synchronize()
    return Y[:n_out, :N]


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits, to nearest, ties away)."""
    import torch
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def accumulator_probe(lib, dev, smi) -> dict:
    """One mma.sync a k-step on raw TF32 operands (scheme -1): the products
    of 11-bit significands are exact, so the only rounding is the
    accumulator's. K = 8 (one k-step, the bias as C) and K = 64 (eight
    k-steps into one accumulator), against the exact float64 sum rounded to
    nearest (IEEE) and toward zero; the error in units of the exact sum's
    ulp, and its mean sign (a truncating accumulator errs toward zero)."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(7)
    out = {}
    for K in (8, 64):
        W = _tf32(torch.randn((64, K), generator=g) * 2.0 ** torch.randint(-6, 7, (64, K),
                                                                            generator=g))
        X = _tf32(torch.randn((K, 4096), generator=g) * 2.0 ** torch.randint(-6, 7, (K, 4096),
                                                                              generator=g))
        b = torch.randn(64, generator=g) * 4.0
        y = probe_layer(lib, W.to(dev), b.to(dev), X.to(dev), -1).double().cpu()
        exact = W.double() @ X.double() + b.double()[:, None]
        rn = exact.float().double()
        ulp = (torch.nextafter(exact.float().abs(), torch.tensor(float("inf"))).double()
               - exact.float().abs().double())
        rz = torch.where(rn.abs() > exact.abs(), rn - torch.sign(exact) * ulp, rn)
        err = (y - exact) / ulp
        toward_zero = -(err * torch.sign(exact))
        out[f"K{K}"] = {"equal_rn": float((y == rn).double().mean()),
                        "equal_rz": float((y == rz).double().mean()),
                        "max_ulps": float(err.abs().max()),
                        "mean_ulps_toward_zero": float(toward_zero.mean())}
        r = out[f"K{K}"]
        print(f"C6 accumulator probe, K {K} (raw TF32 operands, {y.numel()} sums): equal to the "
              f"exact sum rounded to nearest {r['equal_rn']:.4%}, toward zero "
              f"{r['equal_rz']:.4%}; max |error| {r['max_ulps']:.3f} ulp, mean "
              f"{r['mean_ulps_toward_zero']:.4f} ulp toward zero on {smi}", flush=True)
    return out


def _errors(y, exact, mag):
    """(max, mean, mean signed) error per unit of magnitude, and max |error|."""
    d = y.double() - exact
    rel = d / mag.clamp_min(1e-300)
    return {"max_rel": float(rel.abs().max()), "mean_rel": float(rel.abs().mean()),
            "signed_rel": float(rel.mean()), "max_abs": float(d.abs().max())}


def layer_report(lib, label, W, b, X, smi) -> dict:
    """Each scheme's, the float32 products' and the emulation's errors on
    one layer (W (out, in), b (out,), X (in, N) float32 on the card)."""
    import numpy as np
    import torch
    from test_torch_lstm_mma_plan import _mma_3xtf32
    W, b, X = W.float(), b.float().reshape(-1), X.float()
    exact = W.double() @ X.double() + b.double()[:, None]
    mag = W.double().abs() @ X.double().abs() + b.double().abs()[:, None]
    res = {f"scheme {s} ({n})": _errors(probe_layer(lib, W, b, X, s), exact, mag)
           for s, n in SCHEMES.items()}
    res["float32 card"] = _errors(W @ X + b[:, None], exact, mag)
    cpu = W.cpu() @ X.cpu() + b.cpu()[:, None]
    res["float32 cpu"] = _errors(cpu.to(X.device), exact, mag)
    n = min(EMULATED_COLUMNS, X.shape[1])
    from or_gym_inventory_torch.ops import episode_kernels as ek
    Wp = np.zeros((ek._pad16(W.shape[0]), ek._pad8(W.shape[1])), np.float32)
    Wp[:W.shape[0], :W.shape[1]] = W.cpu().numpy()
    Xp = np.zeros((ek._pad8(W.shape[1]), n), np.float32)
    Xp[:W.shape[1]] = X[:, :n].cpu().numpy()
    emu = (_mma_3xtf32(Wp, Xp)[:W.shape[0]] + b.cpu().numpy()[:, None]).astype(np.float32)
    res["emulated first design"] = _errors(torch.from_numpy(emu).to(X.device), exact[:, :n],
                                           mag[:, :n])
    f32 = res["float32 card"]["max_rel"]
    print(f"C6 probe {label} ({W.shape[0]} x {W.shape[1]}, {X.shape[1]} columns) on {smi}: "
          "max / mean |error| per unit of sum |W||x| + |b|, mean signed: " + "; ".join(
              f"{k} {v['max_rel']:.3g} / {v['mean_rel']:.3g}, {v['signed_rel']:+.2g} "
              f"({v['max_rel'] / max(f32, 1e-300):.2f}x float32's max)"
              for k, v in res.items()), flush=True)
    return res


def forward_report(lib, label, actor, X, smi) -> dict:
    """The whole actor (tanh between the layers, on the card in float32)
    with each of FORWARD_SCHEMES' products, and with the float32 plain
    product (cuBLAS, TF32 off), against the float64 forward of the same
    obs X (in, N): each output's max |diff|, and its ratio to the float32
    plain forward's (what phase 58's C6 gate holds to at most 2)."""
    import torch
    Ws, bs = actor
    want = X.double()
    for layer, (W, b) in enumerate(zip(Ws, bs)):
        want = W.T.double() @ want + b.double()[:, None]
        if layer < len(Ws) - 1:
            want = torch.tanh(want)

    def run(product):
        H = X
        for layer, (W, b) in enumerate(zip(Ws, bs)):
            H = product(W.T.contiguous(), b, H)
            if layer < len(Ws) - 1:
                H = torch.tanh(H)
        return float((H.double() - want).abs().max())
    e32 = run(lambda W, b, H: W @ H + b[:, None])
    res = {"float32 card": e32}
    for sch in FORWARD_SCHEMES:
        res[f"scheme {sch} ({SCHEMES[sch]})"] = run(
            lambda W, b, H, sch=sch: probe_layer(lib, W, b, H, sch))
    print(f"C6 forward {label} ({X.shape[1]} columns) on {smi}: output max |diff| to float64 "
          "(ratio to float32's): " + "; ".join(f"{k} {v:.4g} ({v / max(e32, 1e-300):.2f})"
                                               for k, v in res.items()), flush=True)
    return res


def _columns(obs_all, dev):
    """PROBE_COLUMNS (obs_dim, N) float32 columns of a (T, B, obs_dim)
    observation stream, evenly spaced."""
    import torch
    flat = obs_all.reshape(-1, obs_all.shape[-1])
    idx = torch.linspace(0, flat.shape[0] - 1, min(PROBE_COLUMNS, flat.shape[0]),
                         device=flat.device).long()
    return flat[idx].T.contiguous().to(dev, torch.float32)


def probe_layers(lib, dev, smi) -> dict:
    """``layer_report`` on each layer of each C6 actor, at each family's
    observations under it, the layers' inputs the float64 forward's
    activations rounded to float32; then LSTM-256's gate product over K24's
    observations and the float64 LSTM's H."""
    import torch

    import chip_smoke as cs
    from or_gym_inventory_torch.envs import inv_management as im
    from or_gym_inventory_torch.ops import episode_kernels as ek
    out = {}
    for family, k in cs.C6_TRAJ.items():
        params, obs_dim, act, wrapper, _ = cs.c6_family(family)
        for kind, (actor, log_std) in cs.c6_actors(obs_dim, act).items():
            on = tuple(tuple(x.to(dev) for x in part) for part in actor)
            tr = wrapper(params, on, log_std.to(dev), cs.SEED, cs.C6_LANES, device=dev)
            X = _columns(cs.traj_obs(family, params, tr), dev)
            del tr
            out[f"{k} {kind} forward"] = forward_report(lib, f"{k} {kind}", on, X, smi)
            for layer, (W, b) in enumerate(zip(*on)):
                out[f"{k} {kind} layer {layer}"] = layer_report(
                    lib, f"{k} {kind} layer {layer}", W.T, b, X, smi)
                X = (W.T.double() @ X.double() + b.double()[:, None])
                X = torch.tanh(X).float() if layer < len(on[0]) - 1 else X.float()
    params = im.default_params()
    actor, log_std = cs.seeded_lstm_actor(params, dev, encoder=(), hidden=256)
    tr = ek.rollout_traj_im_lstm(params, actor, log_std, cs.SEED, cs.C6_LANES, device=dev)
    obs_all = im.assemble_obs_from_streams(params, tr["inv"], tr["actions"])
    a64 = ek._lstm_on(actor, dev, torch.float64)
    h = a64["wh"].shape[1]
    H = torch.zeros((h, cs.C6_LANES), dtype=torch.float64, device=dev)
    C, cols = torch.zeros_like(H), []
    for t in range(obs_all.shape[0] - 1):
        x = obs_all[t].T.float()
        cols.append(torch.cat([x, H.float()]))
        _, H, C, _, _ = ek.lstm_forward(a64, list(x), H, C, torch.float64)
    X = torch.cat(cols, 1)
    X = X[:, torch.linspace(0, X.shape[1] - 1, PROBE_COLUMNS, device=dev).long()]
    W = torch.cat([actor["wx"], actor["wh"]], 1)
    out["K24 LSTM-256 gates"] = layer_report(lib, "K24 LSTM-256 gates", W, actor["bh"], X, smi)
    return out


@contextlib.contextmanager
def rounded_actors():
    """The plain versions with each actor evaluation (``mlp_forward``, and
    ``lstm_forward``'s cell) computed in float64 and rounded once to
    float32: the trajectory of an actor that is as exact as a float32
    result can be, the reference a more exact kernel should follow at
    least as far as the float32 plain version does."""
    import torch

    from or_gym_inventory_torch.ops import episode_kernels as ek
    mlp, lstm = ek.mlp_forward, ek.lstm_forward

    def mlp64(layers, act_name, obs_rows, dtype=torch.float32):
        if dtype != torch.float32:
            return mlp(layers, act_name, obs_rows, dtype)
        l64 = [(W.double(), b.double()) for W, b in layers]
        return mlp(l64, act_name, obs_rows, torch.float64)[0].float()

    def lstm64(actor, obs_rows, H, C, dtype=torch.float32, err=None):
        if dtype != torch.float32:
            return lstm(actor, obs_rows, H, C, dtype, err)
        a64 = {"enc": [(W.double(), b.double()) for W, b in actor["enc"]],
               **{k: actor[k].double() for k in ("wx", "wh", "bh", "wm", "bm")}}
        m, H2, C2, _, _ = lstm(a64, obs_rows, H.double(), C.double(), torch.float64)
        return m.float(), H2.float(), C2.float()
    ek.mlp_forward, ek.lstm_forward = mlp64, lstm64
    try:
        yield
    finally:
        ek.mlp_forward, ek.lstm_forward = mlp, lstm


def lane_shares(dev, smi) -> dict:
    """The free-running lane shares of the module's notes: {case: {the
    kernel against plain on the card, plain on the card against plain on
    the CPU, and each of the kernel and plain on the card against the
    plain version with correctly rounded actors on the card
    (``rounded_actors``)}}."""
    import torch

    import chip_smoke as cs
    from or_gym_inventory_torch.envs import inv_management as im
    from or_gym_inventory_torch.ops import episode_kernels as ek
    from or_gym_inventory_torch.ops import net_step as ns
    cpu = torch.device("cpu")
    evaluators = {"net": ("K5", ns.episode_returns_net_policy, ns._policy_returns_plain),
                  "im": ("K11", ek.episode_returns_im_policy, ek._im_policy_plain),
                  "nv": ("K19", ek.episode_returns_nv_policy, ek._nv_policy_plain)}
    traj_plain = {"net": ns._rollout_traj_plain, "im": ek._rollout_traj_im_plain,
                  "nv": ek._rollout_traj_nv_plain}

    def on(actor, device):
        return tuple(tuple(x.to(device) for x in part) for part in actor)

    def record(name, got, plain_dev, plain_cpu, rounded):
        tile, _ = cs.lane_share(f"{name} kernel", got, plain_dev, need=0.0)
        own, _ = cs.lane_share(f"{name} plain", plain_dev, plain_cpu.to(dev), need=0.0)
        tile_r, _ = cs.lane_share(f"{name} kernel, rounded", got, rounded, need=0.0)
        plain_r, _ = cs.lane_share(f"{name} plain, rounded", plain_dev, rounded, need=0.0)
        shares[name] = {"kernel_vs_plain_on_card": tile, "plain_on_card_vs_plain_on_cpu": own,
                        "points_short": 100 * (own - tile), "kernel_vs_rounded": tile_r,
                        "plain_on_card_vs_rounded": plain_r}
        print(f"C6 shares {name} on {smi}: kernel vs plain on the card {tile:.4%} of lanes "
              f"within rtol=1e-4 atol=1e-2; plain on the card vs plain on the CPU {own:.4%} "
              f"({100 * (own - tile):+.2f} points); against the correctly rounded actor's "
              f"trajectory: kernel {tile_r:.4%}, plain on the card {plain_r:.4%}", flush=True)
    shares = {}
    B, E = cs.C6_LANES, cs.C6_EPISODES
    for family, (k, entry, plain) in evaluators.items():
        params, obs_dim, act, wrapper, _ = cs.c6_family(family)
        for kind, (actor, log_std) in cs.c6_actors(obs_dim, act).items():
            for mode in ("det", "stoch"):
                ls = log_std if mode == "stoch" else None
                std = None if ls is None else ek.clipped_std(ls)
                got = entry(params, on(actor, dev), cs.SEED, B, E,
                            None if ls is None else ls.to(dev), dev)
                p_dev = plain(params, on(actor, dev), None if std is None else std.to(dev),
                              cs.SEED, B, E, dev)[0]
                p_cpu = plain(params, on(actor, cpu), std, cs.SEED, B, E, cpu)[0]
                with rounded_actors():
                    p_ref = plain(params, on(actor, dev), None if std is None else std.to(dev),
                                  cs.SEED, B, E, dev)[0]
                record(f"{k} {kind} {mode} ({B} x {E})", got, p_dev, p_cpu, p_ref)
            std = ek.clipped_std(log_std)
            tr = wrapper(params, on(actor, dev), log_std.to(dev), cs.SEED, B, device=dev)
            p_dev = traj_plain[family](params, on(actor, dev), std.to(dev), cs.SEED, B, dev)
            p_cpu = traj_plain[family](params, on(actor, cpu), std, cs.SEED, B, cpu)
            with rounded_actors():
                p_ref = traj_plain[family](params, on(actor, dev), std.to(dev), cs.SEED, B, dev)
            record(f"{cs.C6_TRAJ[family]} {kind} rewards ({B} x {tr['reward'].shape[0]})",
                   tr["reward"], p_dev["reward"], p_cpu["reward"], p_ref["reward"])
    params = im.default_params()
    actor, log_std = cs.seeded_lstm_actor(params, dev, encoder=(), hidden=256)
    std = ek.clipped_std(log_std)
    tr = ek.rollout_traj_im_lstm(params, actor, log_std, cs.SEED, B, device=dev)
    p_dev = ek._rollout_traj_im_lstm_plain(params, actor, std, cs.SEED, B, dev)
    p_cpu = ek._rollout_traj_im_lstm_plain(params, ek._lstm_on(actor, cpu), std.cpu(), cs.SEED,
                                           B, cpu)
    with rounded_actors():
        p_ref = ek._rollout_traj_im_lstm_plain(params, actor, std, cs.SEED, B, dev)
    record(f"K24 LSTM-256 rewards ({B} x {params.periods})", tr["reward"], p_dev["reward"],
           p_cpu["reward"], p_ref["reward"])
    return shares


def kernel_turns(dev, parent_libs, rounds, smi) -> dict:
    """The 12 kernels in turns with the parent (``actor_sweep.turns``, a
    difference recorded): {name: results}."""
    import actor_sweep
    import lstm_caps_sweep
    res = actor_sweep.turns(dev, parent_libs, TILE_KERNELS, rounds, bits=False)
    res.update(actor_sweep.turns(dev, parent_libs, LSTM_KERNELS, rounds,
                                 make=lstm_caps_sweep.cases, bits=False))
    for name, r in res.items():
        print(f"C6 turns {actor_sweep.line(name, r)}; max |diff| against the parent "
              f"{r['max_abs_diff']:.3g} on {smi}", flush=True)
    return res


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("c6_sweep.py: no CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--probe", action="store_true")
    ap.add_argument("--shares", action="store_true")
    ap.add_argument("--turns", action="store_true")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not (args.probe or args.shares or args.turns):
        args.probe = args.shares = args.turns = True
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from or_gym_inventory_torch.ops import _build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    dev = torch.device("cuda", 0)
    jobs = start_builds(args.turns)
    logs = _build.build()
    probe, parents, plogs = finish_builds(jobs)
    import chip_smoke as cs
    result = {"card": smi, "ptxas": {pathlib.Path(k).name: cs.ptxas_entries(v)
                                     for k, v in logs.items()}, "parent_ptxas": plogs}
    for name, line in result["ptxas"].items():
        if any(s in name for s in ("policy", "lstm")):
            print(f"ptxas ({name}): {line}", flush=True)
    if logs:   # this run built the package: whether its tile kernels hold HMMA, spill nothing
        try:
            result["tile_sass"] = cs.tile_sass_check(logs)
        except AssertionError as err:   # reported here; chip_smoke.py's phase 2 gates it
            result["tile_sass"] = f"FAILED: {err}"
        print(f"tile kernels (LDL/STL/HMMA): {result['tile_sass']}", flush=True)
    if args.probe:
        result["accumulator"] = accumulator_probe(probe, dev, smi)
        result["layers"] = probe_layers(probe, dev, smi)
    if args.shares:
        result["shares"] = lane_shares(dev, smi)
    if args.turns:
        result["turns"] = kernel_turns(dev, parents, args.rounds, smi)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
