"""CABAC context-table generator for the latent-value entropy coder.

Counterpart of ``coolchic_tpu/bitstream/contexts.py`` (numpy only, the
port's own copy). ``cpp/gen_contexts.inc`` is tracked, so the C++ build
needs nothing generated; ``emit_inc_file`` regenerates it elsewhere.

The bitstream codes each latent value against one of 17 x 50 static CABAC
contexts indexed by (quantized mu offset, quantized log sigma). The tables
are *generated* from Laplace CDF probabilities mapped to the nearest CABAC
probability state — this module reproduces that generator
(reference: coolchic/enc/utils/bac_contexts.py:39-295 and the probability->
state table coolchic/enc/utils/misc.py:300-377); the emitted values are
format constants shared with the C++ entropy backend via a generated
``gen_contexts.inc``.

All arithmetic is float32 to match the reference's torch defaults — the
argmin-to-state mapping is sensitive to rounding.
"""

from __future__ import annotations

import os

import numpy as np

N_MUQ = 16  # number of mu offsets
N_SIGQ = 50  # number of quantized log-sigma bins
SIG_LOG_MIN = -1  # in the set
SIG_LOG_MAX_EXCL = 9  # not in the set
ARM_PRECISION = 8  # fixed-point fractional bits of the integer ARM
ARM_SCALE = 1 << ARM_PRECISION
PROBA_50_STATE = 2 * 32 + 1

P_MIN = np.float32(0.001)
P_MAX = np.float32(1 - 0.001)

# Measured p(MPS=0) of each CABAC state pair ((2i+1)<<8 in m_state[0/1]);
# format constant (reference: misc.py:300-367).
# fmt: off
PROBA0_MPS = np.array([
    0.9891080263649208, 0.9746796308915489, 0.9588652555405722, 0.9438961210609208,
    0.9289674808078398, 0.9144650894999015, 0.8988797291640259, 0.8849083818638724,
    0.8705505632961241, 0.8542913027588402, 0.8408964152537145, 0.8235910172675731,
    0.8098350556562219, 0.7937188645720145, 0.7772227308111015, 0.7659913470050881,
    0.743033931648849, 0.7348898852047242, 0.7178727301215397, 0.7071067811865476,
    0.6870085695324213, 0.6729634236899158, 0.6597996876307916, 0.6433608266170463,
    0.6299896359774878, 0.6155722066724582, 0.6040333034402598, 0.5832959652701518,
    0.5705795714817147, 0.5520611562919205, 0.5412248551068882, 0.5244946637874729,
    0.5, 0.4585020216023356, 0.4528797696244531, 0.43527528164806206,
    0.42044820762685725, 0.39685943228600723, 0.39685943228600723, 0.37151696582442445,
    0.3535533905932738, 0.3364817118449579, 0.32987697769322355, 0.31499481798874385,
    0.29730177875068026, 0.2806219957472792, 0.2726269331663144, 0.25,
    0.25, 0.2227349718384631, 0.2050858697731751, 0.19842971614300361,
    0.1767766952966369, 0.16493848884661177, 0.14865088937534013, 0.1363134665831572,
    0.125, 0.10254293488658756, 0.08838834764831845, 0.07432544468767006,
    0.0625, 0.04419417382415922, 0.03125, 0.015625,
], dtype=np.float64)
# fmt: on


def bac_state_idx_from_proba_0(p0: float) -> int:
    """Closest CABAC state index for a probability of coding 0
    (reference: misc.py:371-377). Returns values in [1..127:2]."""
    return int(np.argmin(np.abs(PROBA0_MPS - float(p0)))) * 2 + 1


def _laplace_cdf(x, mu, scale):
    x = np.float32(x)
    shifted = np.float32(x - mu)
    return np.float32(0.5) - np.float32(0.5) * np.sign(shifted) * np.float32(
        np.expm1(np.float32(-np.abs(shifted) / scale))
    )


def _reasonable(p):
    p = np.float32(abs(p))
    if p < P_MIN:
        p = P_MIN
    if p > P_MAX:
        p = P_MAX
    return p


def generate_context_states() -> np.ndarray:
    """[N_MUQ + 1, N_SIGQ, 5] int16 state indices (gt0, gt1, gt2, gt3, ppos)
    (reference: bac_contexts.py:39-171)."""
    log_sigs = np.arange(
        SIG_LOG_MIN, SIG_LOG_MAX_EXCL, (SIG_LOG_MAX_EXCL - SIG_LOG_MIN) / N_SIGQ,
        dtype=np.float32,
    )
    sigs = np.exp(log_sigs - np.float32(4.0), dtype=np.float32)

    out = np.zeros((N_MUQ + 1, N_SIGQ, 5), np.int16)
    for mi, mu_offset in enumerate(range(-N_MUQ // 2, N_MUQ // 2 + 1)):
        mu = np.float32(mu_offset) / np.float32(N_MUQ)
        for si, sig in enumerate(sigs):
            def band(k):
                return (
                    _laplace_cdf(k + 0.5, mu, sig) - _laplace_cdf(k - 0.5, mu, sig)
                )

            gt0_surface = band(0)
            gt0 = _reasonable(gt0_surface)
            if gt0 == P_MAX:
                gt1 = gt2 = gt3 = np.float32(0.5)
            else:
                gt1_surface = band(1) + band(-1)
                if gt1_surface <= P_MIN:
                    gt1 = gt2 = gt3 = np.float32(0.5)
                else:
                    gt1 = _reasonable(gt1_surface / (1 - gt0_surface))
                    gt2_surface = band(2) + band(-2)
                    if gt2_surface <= P_MIN:
                        gt2 = gt3 = np.float32(0.5)
                    else:
                        gt2 = _reasonable(
                            gt2_surface / (1 - gt0_surface - gt1_surface)
                        )
                        gt3_surface = band(3) + band(-3)
                        if gt3_surface <= P_MIN:
                            gt3 = np.float32(0.5)
                        else:
                            gt3 = _reasonable(
                                gt3_surface
                                / (1 - gt0_surface - gt1_surface - gt2_surface)
                            )

            pos_surface = np.float32(1.0) - _laplace_cdf(0.5, mu, sig)
            neg_surface = _laplace_cdf(-0.5, mu, sig)
            if pos_surface <= P_MIN and neg_surface <= P_MIN:
                ppos = np.float32(0.5)
            elif pos_surface <= P_MIN:
                ppos = np.float32(0.0)
            elif neg_surface <= P_MIN:
                ppos = np.float32(1.0)
            else:
                ppos = pos_surface / (pos_surface + neg_surface)
            ppos = _reasonable(ppos)

            out[mi, si] = [
                bac_state_idx_from_proba_0(p) for p in (gt0, gt1, gt2, gt3, ppos)
            ]
    return out


def emit_inc_file(path: str) -> None:
    """Write the generated table as a C array include (consumed by
    cpp/entropy_api.cpp)."""
    states = generate_context_states()
    with open(path, "w") as f:
        f.write("// GENERATED by coolchic_tpu/bitstream/contexts.py — do not edit.\n")
        f.write(
            f"static const short kContextStates[{N_MUQ + 1}][{N_SIGQ}][5] = {{\n"
        )
        for mi in range(N_MUQ + 1):
            f.write("{")
            for si in range(N_SIGQ):
                g = states[mi, si]
                f.write(f"{{{g[0]},{g[1]},{g[2]},{g[3]},{g[4]}}},")
            f.write("},\n")
        f.write("};\n")


def get_val_mu_indices(val_mu: int, val_log_sig: int):
    """Fixed-point (ARM_PRECISION) quantizer from integer (mu, log sigma) to
    (rounded mu, mu bin, log-sigma bin) — must match the C++ decoder exactly
    (reference: cpp/cc-contexts.h:20-48). Inputs are mu*256 and
    log_sigma*256 as ints."""
    if val_mu >= 0:
        mu_rounded = ((val_mu + ARM_SCALE // 2) >> ARM_PRECISION) << ARM_PRECISION
    else:
        mu_rounded = -(((-val_mu + ARM_SCALE // 2) >> ARM_PRECISION) << ARM_PRECISION)

    mu_index = (val_mu - mu_rounded) * N_MUQ
    if mu_index >= 0:
        mu_index = (mu_index + ARM_SCALE // 2) >> ARM_PRECISION
    else:
        mu_index = -((-mu_index + ARM_SCALE // 2) >> ARM_PRECISION)
    mu_index += N_MUQ // 2

    v = val_log_sig - SIG_LOG_MIN * ARM_SCALE
    if v < 0:
        sig_index = 0
    else:
        sig_index = (v * (N_SIGQ // (SIG_LOG_MAX_EXCL - SIG_LOG_MIN)) + ARM_SCALE // 2) >> ARM_PRECISION
        if sig_index >= N_SIGQ:
            sig_index = N_SIGQ - 1

    return mu_rounded >> ARM_PRECISION, mu_index, sig_index


if __name__ == "__main__":
    import sys

    if len(sys.argv) != 2:
        sys.exit("usage: python -m coolchic_tpu_torch.bitstream.contexts OUT.inc")
    emit_inc_file(sys.argv[1])
    print("wrote", os.path.abspath(sys.argv[1]))
