"""GGX microfacet BSDF of the wavefront path (counterpart of
`mcpt_tpu/bsdf.py:55-370`, the component `*_c` functions).

The arithmetic is the megakernel's plain version's (`kernels/megakernel_ref.py`,
the same Material.hpp formulas in the same float32 order), which this module
calls rather than copies: eval and pdf there select the half vector of the
lane's branch first and evaluate D, G and F once, which gives each lane the
value the JAX function's separate reflect/refract terms give it. The
functions run as PyTorch ops on (B,) (or broadcastable) tensors; vectors are
3-tuples.

`MatLane` holds a lane's material with its reflectance and emission already
picked at the lane's channel (the wavefront traces one wavelength per lane),
so `gather_material` takes the channel and `reflectance_c` does not.
"""

from mcpt_tpu_torch.kernels import megakernel_ref as R

d_ggx_c = R.d_ggx
g1_smith_c = R.g1
chessboard_reflectance_uv = R.chessboard
tangent_frame_c = R.tangent_frame
sample_ggx_h_c = R.sample_ggx_h
sample_mfn_c = R.sample_mfn


class MatLane(dict):
    """Per-lane material: mtype, ior_a, ior_b, rough, refl and emit (at the
    lane's channel), textured, dirac, as float tensors (the keys of
    `megakernel_ref.gather_mat`)."""


def gather_material(pack, mat_ids, chan) -> MatLane:
    """Rows of `pack.mat_fat` at `mat_ids` (plain indexing; a zero row for
    ids outside the table), channel-picked at `chan`."""
    return MatLane(R.gather_mat(pack.mat_fat, mat_ids.float(), chan))


def ior_of(m, lam):
    """2-term Cauchy dispersion (Material.hpp:178-183)."""
    return m["ior_a"] + m["ior_b"] / (lam * lam)


def g_smith_c(wi, wo, n, alpha):
    """Product of the two G1s (Material.hpp:70-77)."""
    return g1_smith_c(wi, n, alpha) * g1_smith_c(wo, n, alpha)


def reflectance_c(m, uv):
    """Scalar reflectance at the lane's channel (Material.hpp:134-151)."""
    return R.reflectance(m, uv)


def fresnel_c(m, incident, nrm, lam):
    """Unpolarized dielectric Fresnel with TIR; 1 for conductors
    (Material.hpp:198-226); `incident` points into the surface."""
    return R.fresnel(m, ior_of(m, lam), incident, nrm)


def refract_c(m, incident, nrm, lam):
    """Snell refraction, zero on TIR (Material.hpp:227-242)."""
    return R.refract(ior_of(m, lam), incident, nrm)


def pdf_c(m, wi, wo, n, lam, is_reflect):
    """Material::pdf (Material.hpp:285-328)."""
    return R.pdf(m, ior_of(m, lam), wi, wo, n, is_reflect)


def eval_bsdf_c(m, wi, wo, n, lam, uv, is_reflect):
    """Material::eval (Material.hpp:330-408): wi toward the light or next
    vertex, wo toward the viewer, n the macro normal."""
    return R.eval_bsdf(m, ior_of(m, lam), reflectance_c(m, uv), wi, wo, n, is_reflect)
