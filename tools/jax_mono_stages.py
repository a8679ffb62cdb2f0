#!/usr/bin/env python3
"""The JAX package's mono odometer at frames 28 and 61 of chip_smoke.py's
corridor, stage by stage, written to tests/data/mono_stages.npz.

    JAX_PLATFORMS=cpu python3 tools/jax_mono_stages.py

Renders chip_smoke.py's 64-frame corridor at 1242x376 and runs
``openvo_tpu.models.mono_odometer.MonoOdometer`` over its left images up
to the last frame named in FRAMES, as tools/jax_mono_reference.py does.
Before each named frame's update it recomputes that update's stages from
the odometer's state with the JAX package's own functions and saves them
under ``f<frame>_<name>``:

- ORB of the frame (``kp_xy``, ``desc``, ``kp_valid``) and the state's
  (``cur_xy``, ``cur_desc``, ``cur_valid``), the ratio test's
  ``train_idx`` and ``mok``, the normalized ``x1``, ``x2``;
- the draw: the uniforms ``u`` (iters, 5) and the sample indices ``idx``;
- the five-point candidates ``Es`` (iters, 10, 3, 3), ``valid`` and their
  MSAC scores ``msac``; the top 8 (``top_i``, ``top_m``), their
  cheirality ``support``, ``eligible`` and the chosen slot ``best``;
- the two guarded refits: ``E_ref`` (2, 3, 3), ``m_ref``, ``sup_ref``,
  ``ref_ok``; the result ``E``, ``inliers``, ``n_inl``;
- recoverPose: ``R``, ``t``, ``support_mask`` and the four candidates'
  counts ``pose_counts``.

It records whether the update's own stats equal the recomputed ones
(``f<frame>_same_as_update``): XLA may fuse the one program otherwise than
the other. Then it runs the port's MonoOdometer on the CPU over the
same frames with JAX's draws replayed, and saves the port's ORB and
matches at the named frames (``f<frame>_port_*``), so the tests can tell
whether the stages before RANSAC already part. About 3 minutes and 2 GB
on the CPU; the npz is under 400 KB.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

OUT = os.path.join(ROOT, "tests", "data", "mono_stages.npz")
FRAMES = (28, 61)


def jax_stages(odo, K, img):
    """The stages of ``odo``'s next update on ``img``, recomputed in one
    jitted program that mirrors the update's (openvo_tpu/models/
    mono_odometer.py:make_step, openvo_tpu/pose/ransac.py:
    ransac_essential_5pt)."""
    import jax
    import jax.numpy as jnp

    from openvo_tpu.ops.hamming import ratio_test_match
    from openvo_tpu.ops.orb import detect_and_compute
    from openvo_tpu.pose import ransac as R
    from openvo_tpu.pose.fivepoint import five_point_candidates

    K = np.asarray(K, np.float64)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    thresh = float((1.0 / ((fx + fy) * 0.5)) ** 2)
    iters = chip_smoke.MONO_ITERS
    cfg = odo.config

    def normalize(xy):
        return jnp.stack([(xy[:, 0] - cx) / fx, (xy[:, 1] - cy) / fy], axis=1)

    def stages(st, img):
        feats = detect_and_compute(img.astype(jnp.float32), None, cfg.orb)
        train_idx, mok = ratio_test_match(st.cur.desc, feats["desc"],
                                          cfg.match_threshold,
                                          st.cur.kp_valid, feats["valid"])
        x1 = normalize(st.cur.kp_xy)
        x2 = normalize(jnp.take(feats["xy"], train_idx, axis=0))
        _, sub = jax.random.split(st.key)
        u = jax.random.uniform(sub, (iters, 5), dtype=jnp.float32)
        idx = R._sample_indices(sub, iters, 5, x1.shape[0], mok)

        def msac_of(E):
            err = R.sampson_error(E, x1, x2)
            return jnp.sum(jnp.where(mok, jnp.minimum(err, thresh), 0.0))

        def support_of(E):
            inl = (R.sampson_error(E, x1, x2) < thresh) & mok
            _, _, good = R.recover_pose(E, x1, x2, inl)
            return jnp.sum(good.astype(jnp.int32))

        def hypothesis(ids):
            Es, valid = five_point_candidates(x1[ids], x2[ids])
            s = jax.vmap(msac_of)(Es)
            return jnp.where(valid, s, jnp.inf), Es, valid

        msac, Es, valid = jax.vmap(hypothesis)(idx)
        neg, top_i = jax.lax.top_k(-msac.reshape(-1), 8)
        top_m = -neg
        top_E = Es.reshape(-1, 3, 3)[top_i]
        support = jax.vmap(support_of)(top_E)
        margin = jnp.maximum(0.02 * top_m[0], 1e-3 * thresh * jnp.sum(mok))
        eligible = top_m <= top_m[0] + margin
        best = jnp.argmax(jnp.where(eligible, support, -1))
        E, cur_m, cur_sup = top_E[best], top_m[best], support[best]
        inliers = (R.sampson_error(E, x1, x2) < thresh) & mok
        E_ref, m_ref, sup_ref, ref_ok = [], [], [], []
        for _ in range(2):
            Er = R._masked_eight_point(x1, x2, inliers)
            mr, sr = msac_of(Er), support_of(Er)
            ok = ((mr <= 1.5 * cur_m)
                  & (sr.astype(jnp.float32)
                     >= 0.7 * cur_sup.astype(jnp.float32))
                  & jnp.all(jnp.isfinite(Er)))
            E = jnp.where(ok, Er, E)
            cur_m = jnp.where(ok, mr, cur_m)
            cur_sup = jnp.where(ok, sr, cur_sup)
            inliers = (R.sampson_error(E, x1, x2) < thresh) & mok
            E_ref.append(Er), m_ref.append(mr), sup_ref.append(sr)
            ref_ok.append(ok)
        Rm, t, good = R.recover_pose(E, x1, x2, inliers)
        # the four (R, t) candidates' cheirality counts
        uu, _, vt = jnp.linalg.svd(E)
        uu = uu * jnp.sign(jnp.linalg.det(uu))
        vt = vt * jnp.sign(jnp.linalg.det(vt))
        w = jnp.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
        counts = []
        for Rc, tc in ((uu @ w @ vt, uu[:, 2]), (uu @ w @ vt, -uu[:, 2]),
                       (uu @ w.T @ vt, uu[:, 2]), (uu @ w.T @ vt, -uu[:, 2])):
            a, b, z1, z2 = R._triangulate_depths(Rc, tc, x1, x2)
            counts.append(jnp.sum((a > 0) & (b > 0) & (z1 > 0) & (z2 > 0)
                                  & inliers))
        return dict(
            kp_xy=feats["xy"], desc=feats["desc"], kp_valid=feats["valid"],
            cur_xy=st.cur.kp_xy, cur_desc=st.cur.desc,
            cur_valid=st.cur.kp_valid, train_idx=train_idx, mok=mok, x1=x1,
            x2=x2, u=u, idx=idx, Es=Es, valid=valid, msac=msac, top_i=top_i,
            top_m=top_m, support=support, eligible=eligible, best=best,
            E_ref=jnp.stack(E_ref), m_ref=jnp.stack(m_ref),
            sup_ref=jnp.stack(sup_ref), ref_ok=jnp.stack(ref_ok), E=E,
            inliers=inliers, n_inl=jnp.sum(inliers.astype(jnp.int32)), R=Rm,
            t=t, support_mask=good, pose_counts=jnp.stack(counts))

    out = jax.jit(stages)(odo._state, jnp.asarray(np.asarray(img)))
    out = {k: np.asarray(v) for k, v in out.items()}
    out["thresh"] = np.float32(thresh)
    return out


def main() -> int:
    import jax
    import torch

    from openvo_tpu.models.mono_odometer import MonoOdometer
    from openvo_tpu_torch.models import mono_odometer as port_mono

    seq = chip_smoke.render_sequence(workers=4)
    n = max(FRAMES) + 1
    odo = MonoOdometer(seq["K"])
    out = {"jax_version": np.asarray(jax.__version__), "frames":
           np.asarray(FRAMES)}
    t0 = time.perf_counter()
    for i in range(n):
        if i in FRAMES:
            st = jax_stages(odo, seq["K"], seq["left"][i])
            out.update({f"f{i}_{k}": v for k, v in st.items()})
            out[f"f{i}_T_wc"] = np.stack([seq["T_wc"][i - 1],
                                          seq["T_wc"][i]])
        odo.update(seq["left"][i], trans_scale=chip_smoke.SEQ["step"])
        if i in FRAMES:
            s = odo.last_stats
            same = (int(s["n_inliers"]) == int(st["n_inl"])
                    and int(s["n_support"]) == int(st["support_mask"].sum()))
            out[f"f{i}_same_as_update"] = np.asarray(same)
            print(f"frame {i}: the recomputed stages "
                  f"{'equal' if same else 'differ from'} the update's stats "
                  f"{s} (recomputed: {int(st['n_inl'])} inliers, "
                  f"{int(st['support_mask'].sum())} support)", flush=True)
        print(f"jax frame {i}: {time.perf_counter() - t0:.1f} s", flush=True)

    ref = np.load(os.path.join(ROOT, chip_smoke.JAX_REFERENCE))
    podo = port_mono.MonoOdometer(seq["K"], device="cpu")
    torch.set_num_threads(4)
    for i in range(n):
        if i in FRAMES:
            feats = port_orb(podo, seq["left"][i])
            out.update({f"f{i}_port_{k}": v for k, v in feats.items()})
        podo.update(seq["left"][i], trans_scale=chip_smoke.SEQ["step"],
                    u=torch.from_numpy(ref["mono_u"][i]))
        print(f"port frame {i}: {time.perf_counter() - t0:.1f} s", flush=True)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(OUT, **out)
    print(f"written to {OUT} ({os.path.getsize(OUT)} bytes)")
    return 0


def port_orb(podo, img):
    """The port's ORB of ``img`` and its matches against ``podo``'s state,
    the stages before RANSAC."""
    import torch

    from openvo_tpu_torch.ops.hamming import ratio_test_match
    from openvo_tpu_torch.ops.orb import detect_and_compute

    st = podo.state
    f = detect_and_compute(torch.as_tensor(img), None, podo.config.orb)
    train_idx, mok = ratio_test_match(st.cur.desc, f["desc"],
                                      podo.config.match_threshold,
                                      st.cur.kp_valid, f["valid"])
    return {"kp_xy": f["xy"].numpy(), "desc": f["desc"].numpy(),
            "kp_valid": f["valid"].numpy(), "cur_xy": st.cur.kp_xy.numpy(),
            "train_idx": train_idx.numpy(), "mok": mok.numpy()}


if __name__ == "__main__":
    sys.exit(main())
