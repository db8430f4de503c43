"""NativeCore — Python face of the C++ host graph service.

Mirrors every symbolic mutation (keyframes, edges, landmarks, observations)
into the C++ core and serves the per-keyframe window build from it.  The
engine drives this alongside its Python ``KeyframeGraph`` (the Python graph
keeps serving the public traversal APIs: ``bfs_visitor``, exporters, ECPs);
the native core owns the hot path.  Interface contract: outputs are
bit-identical to ``srba_tpu.solver.window.build_window`` (tested in
tests/test_native_core.py).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from srba_tpu.native import get_lib
from srba_tpu.solver.window import (E_MIN, L_MIN, N_MIN, WindowArrays,
                                    WindowPlan, _bucket)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


class NativeCore:
    """One instance per engine.  All methods are O(bounded neighborhood)."""

    def __init__(self, max_tree_depth: int):
        lib = get_lib()
        assert lib is not None, "native library unavailable"
        assert max_tree_depth <= 64, (
            "native window builder supports max_tree_depth <= 64 "
            "(fixed path-step buffers); use SRBA_TPU_NO_NATIVE=1 for more")
        self._lib = lib
        self._h = lib.srba_core_new(int(max_tree_depth))
        self._depth = int(max_tree_depth)

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.srba_core_free(self._h)
                self._h = None
        except Exception:
            pass

    # -- mirrored mutations --------------------------------------------------

    def add_keyframe(self) -> int:
        return self._lib.srba_core_add_kf(self._h)

    def add_edge(self, a: int, b: int) -> int:
        e = self._lib.srba_core_add_edge(self._h, a, b)
        assert e >= 0, f"bad edge ({a},{b})"
        return e

    def add_landmark(self, base_kf: int, fixed: bool) -> int:
        return self._lib.srba_core_add_lm(self._h, base_kf, int(fixed))

    def add_observation(self, kf: int, lm: int) -> int:
        o = self._lib.srba_core_add_obs(self._h, kf, lm)
        assert o >= 0, f"bad obs ({kf},{lm})"
        return o

    # -- queries --------------------------------------------------------------

    def path(self, src: int, dst: int,
             max_depth: Optional[int] = None):
        depth = self._depth if max_depth is None else int(max_depth)
        eid = np.empty(depth, np.int32)
        sign = np.empty(depth, np.int32)
        n = self._lib.srba_core_path(self._h, src, dst, depth, depth,
                                     _ptr(eid), _ptr(sign))
        if n < 0:
            return None
        return [(int(eid[i]), int(sign[i])) for i in range(n)]

    def build_window(self, state, root: int, opt_depth: int,
                     tree_depth: int,
                     obs_per_lm_cap: Optional[int] = None
                     ) -> Optional[Tuple]:
        """Native replacement for ``solver.window.build_window(...,
        gather_floats=False)``: returns ``(WindowArrays, WindowPlan)`` with
        obs_z gathered from the host state table by the emitted obs ids.
        ``obs_per_lm_cap`` bounds in-window observations per landmark
        (newest kept) — the window-size guard for dense re-visit regimes."""
        cap_per_lm = 0 if obs_per_lm_cap is None else int(obs_per_lm_cap)
        lib, h = self._lib, self._h
        counts = np.zeros(3, np.int32)
        # Start from the last successful bucket shape FOR THIS DEPTH:
        # windows grow slowly, so the first attempt almost always fits (one
        # native call per KF).  The ratchet is keyed by opt_depth — a deep
        # closure-refinement window (depth = max_tree_depth) must not
        # inflate the padded shape of every subsequent routine window
        # (measured: config#3's per-KF device step grew ~4x after the first
        # depth-4 refinement with a shared ratchet).
        if not isinstance(getattr(self, "_caps", None), dict):
            self._caps = {}
        cap_E, cap_L, cap_N = self._caps.get(
            int(opt_depth), (E_MIN, L_MIN, N_MIN))
        for _ in range(16):  # grows geometrically until it fits
            E, L, N = cap_E, cap_L, cap_N
            edge_gids = np.zeros(E, np.int32)
            edge_opt = np.zeros(E, np.int32)
            lm_gids = np.zeros(L, np.int32)
            lm_opt = np.zeros(L, np.int32)
            obs_ids = np.zeros(N, np.int32)
            obs_lm_local = np.zeros(N, np.int32)
            obs_valid = np.zeros(N, np.int32)
            path_edge = np.zeros((N, tree_depth), np.int32)
            path_sign = np.zeros((N, tree_depth), np.int32)
            rc = lib.srba_core_build_window(
                h, root, opt_depth, tree_depth, E, L, N, cap_per_lm,
                _ptr(counts),
                _ptr(edge_gids), _ptr(edge_opt), _ptr(lm_gids), _ptr(lm_opt),
                _ptr(obs_ids), _ptr(obs_lm_local), _ptr(obs_valid),
                _ptr(path_edge), _ptr(path_sign))
            if rc == -1:
                return None
            if rc == 0:
                break
            # Too small: re-bucket to the required counts and retry.  Keep
            # the ratchet monotone per dimension — replacing a sticky cap
            # with a smaller requirement would re-introduce shape churn.
            cap_E = max(cap_E, _bucket(int(counts[0]), E_MIN))
            cap_L = max(cap_L, _bucket(int(counts[1]), L_MIN))
            cap_N = max(cap_N, _bucket(int(counts[2]), N_MIN))
        else:
            raise RuntimeError("native window build failed to converge")
        self._caps[int(opt_depth)] = (cap_E, cap_L, cap_N)

        E_real, L_real, N_real = (int(counts[0]), int(counts[1]),
                                  int(counts[2]))
        # Emit the RATCHETED caps as the bucket shape: once a dimension has
        # grown, later (smaller) windows keep the grown shape — a new jit
        # shape costs a trace + compile (or cache load) while extra padded
        # compute is dispatch-noise, so never shrink.  Distinct
        # shapes per run = growth events only (~2-4 for a typical run).
        bE, bL, bN = cap_E, cap_L, cap_N
        obs_ids = obs_ids[:bN]
        obs_z = state.obs_z[obs_ids]  # numpy fancy gather (pads = first row)
        arrays = WindowArrays(
            edge_pose=None, edge_opt=edge_opt[:bE].astype(np.float32),
            lm_state=None, lm_opt=lm_opt[:bL].astype(np.float32),
            obs_z=obs_z, obs_lm=obs_lm_local[:bN],
            path_edge=path_edge[:bN],
            path_sign=path_sign[:bN].astype(np.float32),
            obs_valid=obs_valid[:bN].astype(np.float32),
            edge_gids=edge_gids[:bE], lm_gids=lm_gids[:bL])
        plan = WindowPlan(
            edge_ids=edge_gids[:E_real].copy(),
            edge_opt=edge_opt[:E_real].astype(bool),
            lm_ids=lm_gids[:L_real].copy(),
            lm_opt=lm_opt[:L_real].astype(bool),
            num_obs=N_real,
            shape_key=(bE, bL, bN),
        )
        return arrays, plan
