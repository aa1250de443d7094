"""Builds the port's CUDA sources with ``nvcc`` at first use and binds them
with ``ctypes``.

Each ``csrc/*.cu`` becomes one shared library with a plain C interface (no
PyTorch headers, so a build takes seconds), named by a hash of the sources
and flags and placed in ``build/`` at the repository root. All sources are
compiled at once, one ``nvcc`` process each. Nothing is built at import: the
first call of ``library()`` builds what is missing and loads it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _LL, _U32, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_uint32, ctypes.c_float)
# C entry points of each source: {source stem: {name: (argtypes, restype)}};
# every source also exports csrc/launch.cuh's cuda_error_message. The policy
# sources' entry points named *_any take the general actor class
# (csrc/mlp_tile.cuh MlpTileG, csrc/wide_mlp.cuh WideMlpG) with the
# arguments of the entry point without the suffix (``_any`` below); the
# InvManagement entry points named *_chain take the chain route's params
# (csrc/im_step.cuh ImParamsG, past the struct maxima; the policy kernels on
# the general actor class) with them too (``_chain`` below); the LSTM
# kernels' general class (csrc/lstm.cuh LstmG) is csrc/im_lstm_any.cu's,
# *_any and *_chain_any.
SIGNATURES = {
    "net_episode": {
        # topo, small, state layout, staging, acts, dems, disc, out, B, T, stream
        "net_episode_returns": ((_P, _P, _P, _P, _P, _P, _P, _P, _LL, _I, _P), _I),
        # topo, small, layout, threads, disc, tables, out, seed, act_scale, B, E, T,
        # stream
        "net_episode_returns_fused": ((_P, _P, _P, _I, _P, _P, _P, _U32, _F, _LL, _I, _I,
                                       _P), _I),
        # topo, small, tables, acts, dems, seed, act_scale, B, T, e0, e1, stream
        "net_sample_streams": ((_P, _P, _P, _P, _P, _U32, _F, _LL, _I, _I, _I, _P), _I),
        # topo, small, state layout, staging, X, Y, U, RH, acts, dems, X', Y', U',
        # RH', reward, disc, t, lt, B, stream
        "net_batched_step": ((_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _F,
                              _I, _I, _LL, _P), _I),
        # topo, small, layout, threads, dems, disc, out, seed, act_scale, B, T, stream
        "net_episode_returns_random": ((_P, _P, _P, _I, _P, _P, _P, _U32, _F, _LL, _I, _P), _I),
    },
    "net_policy": {
        # topo, small, state layout, tile, actor, tables, disc, x, u, r, raw, reward,
        # demand, seed, B, T, stream
        "net_rollout_traj": ((_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                              _U32, _LL, _I, _P), _I),
        # topo, small, state layout, tile, actor, tables, disc, out, acts, dems, seed,
        # B, E, T, stochastic, stream
        "net_policy_returns": ((_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _U32, _LL,
                                _I, _I, _I, _P), _I),
        # topo, small, state layout, wide, actor, tables, disc, x, u, r, raw, reward,
        # demand, seed, relu, B, T, stream
        "net_rollout_traj_wide": ((_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _U32,
                                   _I, _LL, _I, _P), _I),
        # topo, small, state layout, cluster, actor, tables, disc, x, u, r, raw,
        # reward, demand, seed, relu, B, T, stream
        "net_rollout_traj_cluster": ((_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _U32,
                                      _I, _LL, _I, _P), _I),
        # cluster, relu, small, out
        "net_rollout_traj_cluster_occupancy": ((_P, _I, _I, _P), _I),
    },
    "im_episode": {
        # params, staging layout, acts, dems, disc, out, seed, random, backlog,
        # B, T, stream
        "im_episode_returns": ((_P, _P, _P, _P, _P, _P, _U32, _I, _I, _LL, _I, _P), _I),
        # params, ring layout, table, user_d, disc, out, seed, backlog, B, E,
        # T, stream
        "im_episode_returns_fused": ((_P, _P, _P, _P, _P, _P, _U32, _I, _LL, _I, _I, _P), _I),
        # params, table, user_d, acts, dems, seed, B, E, T, stream
        "im_sample_streams": ((_P, _P, _P, _P, _P, _U32, _LL, _I, _I, _P), _I),
    },
    "im_policy": {
        # params, tile, actor, table, user_d, disc, inv, acts, raw, reward,
        # demand, seed, backlog, B, T, stream
        "im_rollout_traj": ((_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _U32, _I, _LL, _I,
                             _P), _I),
        # params, tile, actor, table, user_d, disc, out, acts, dems, seed,
        # stochastic, backlog, B, E, T, stream
        "im_policy_returns": ((_P, _P, _P, _P, _P, _P, _P, _P, _P, _U32, _I, _I,
                               _LL, _I, _I, _P), _I),
    },
    # K27, a source of its own beside im_policy.cu's tile kernels, so that
    # the two build at once
    "im_offpolicy": {
        # params, wide, actor, table, user_d, disc, inv, acts, raw, reward,
        # demand, seed, relu, backlog, B, T, stream
        "im_rollout_traj_wide": ((_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _U32, _I, _I,
                                  _LL, _I, _P), _I),
        # params, cluster, actor, table, user_d, disc, inv, acts, raw, reward,
        # demand, seed, relu, backlog, B, T, stream
        "im_rollout_traj_cluster": ((_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _U32, _I, _I,
                                     _LL, _I, _P), _I),
        # cluster, relu, backlog, out
        "im_rollout_traj_cluster_occupancy": ((_P, _I, _I, _P), _I),
    },
    "im_lstm": {
        # params, lstm, actor, table, user_d, disc, out, acts, dems, seed,
        # backlog, B, T, stream
        "im_lstm_returns": ((_P, _P, _P, _P, _P, _P, _P, _P, _P, _U32, _I, _LL, _I, _P), _I),
        # params, lstm, actor, table, user_d, disc, inv, acts, raw, reward,
        # demand, seed, backlog, B, T, stream
        "im_lstm_rollout_traj": ((_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _U32, _I, _LL,
                                  _I, _P), _I),
    },
    "nv_episode": {
        # params, econ, acts, dems, disc, out, seed, random, B, T, stream
        "nv_episode_returns": ((_P, _P, _P, _P, _P, _P, _U32, _I, _LL, _I, _P), _I),
        # params, lgamma, econ_in, disc, out, econ_out, acts, dems, seed, B, E,
        # T, stream
        "nv_episodes": ((_P, _P, _P, _P, _P, _P, _P, _P, _U32, _LL, _I, _I, _P), _I),
    },
    "nv_policy": {
        # params, tile, nv tile, actor, lgamma, econ, orders, raw, reward,
        # demand, seed, B, T, stream
        "nv_rollout_traj": ((_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _U32, _LL, _I, _P),
                            _I),
        # params, tile, nv tile, actor, lgamma, disc, out, econ, acts, dems,
        # seed, stochastic, B, E, T, stream
        "nv_policy_returns": ((_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _U32, _I, _LL, _I,
                               _I, _P), _I),
        # out, seed, B, rows, stream
        "sample_normals": ((_P, _U32, _LL, _I, _P), _I),
        # params, wide, actor, lgamma, econ, orders, raw, reward, demand,
        # seed, relu, B, T, stream
        "nv_rollout_traj_wide": ((_P, _P, _P, _P, _P, _P, _P, _P, _P, _U32, _I, _LL, _I, _P),
                                 _I),
        # params, cluster, actor, lgamma, econ, orders, raw, reward, demand,
        # seed, relu, B, T, stream
        "nv_rollout_traj_cluster": ((_P, _P, _P, _P, _P, _P, _P, _P, _P, _U32, _I, _LL, _I,
                                     _P), _I),
        # cluster, relu, out
        "nv_rollout_traj_cluster_occupancy": ((_P, _I, _P), _I),
    },
}
for _stem, _names in (("net_policy", ("net_rollout_traj", "net_policy_returns",
                                        "net_rollout_traj_wide")),
                     ("im_policy", ("im_rollout_traj", "im_policy_returns")),
                     ("im_offpolicy", ("im_rollout_traj_wide",)),
                     ("nv_policy", ("nv_rollout_traj", "nv_policy_returns",
                                    "nv_rollout_traj_wide"))):
    for _name in _names:
        SIGNATURES[_stem][_name + "_any"] = SIGNATURES[_stem][_name]
for _stem in ("im_episode", "im_policy", "im_offpolicy", "im_lstm"):
    for _name in [n for n in SIGNATURES[_stem] if not n.endswith("_any")]:
        SIGNATURES[_stem][_name + "_chain"] = SIGNATURES[_stem][_name]
# the LSTM kernels' general actor class (csrc/lstm.cuh LstmG), a source of
# its own (csrc/im_lstm_any.cu), on either route
SIGNATURES["im_lstm_any"] = {name + suffix: SIGNATURES["im_lstm"][name]
                             for name in ("im_lstm_returns", "im_lstm_rollout_traj")
                             for suffix in ("_any", "_chain_any")}
_SHARED = {"cuda_error_message": ((_I,), ctypes.c_char_p)}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = pathlib.Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the CUDA "
                       "kernels are built with nvcc at first use")


def _target(src: pathlib.Path) -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):   # headers are shared by every source
        h.update(f.name.encode() + f.read_bytes())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build() -> dict:
    """Compile every source whose library is missing, all at once. Returns
    {library path: nvcc's output (registers, spills)}; raises if any build
    fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for src in sorted(CSRC.glob("*.cu")):
        so = _target(src)
        if so.exists():
            continue
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        jobs[so] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    logs = {}
    for so, (tmp, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {so.name}:\n{out}")
        os.replace(tmp, so)   # atomic: a concurrent loader sees all or nothing
        logs[str(so)] = out
    return logs


@functools.lru_cache(maxsize=None)
def library(name: str = "net_episode") -> ctypes.CDLL:
    """The bound library of ``csrc/<name>.cu``, built on first use (with
    every other missing library)."""
    build()
    lib = ctypes.CDLL(str(_target(CSRC / f"{name}.cu")))
    for fn_name, (argtypes, restype) in {**SIGNATURES[name], **_SHARED}.items():
        fn = getattr(lib, fn_name)
        fn.argtypes, fn.restype = list(argtypes), restype
    return lib


def error_string(name: str, err: int) -> str:
    """CUDA's message for the error code ``err`` that an entry point of
    ``csrc/<name>.cu`` returned."""
    return library(name).cuda_error_message(err).decode()
