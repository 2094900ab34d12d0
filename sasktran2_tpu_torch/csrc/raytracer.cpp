// Native spherical-shell ray tracer.
//
// Role of the reference's C++/Rust tracers
// (upstream SASKTRAN2 cpp/lib/raytracing/spherical_shell.cpp,
//  upstream SASKTRAN2 rust/sasktran2-core/src/raytracer/trace.rs): build the
// static per-ray tables (segment OD weights, solar OD weights, boundary
// solar geometry) that the JAX compute path consumes. The Python tracer in
// rt/raytrace.py is the behavioral specification; this implementation must
// produce bit-comparable tables (validated by tests/test_native_tracer.py)
// and exists because the O(rays x segments x shells) host precompute is the
// engine-construction hot path for large limb scans.
//
// C ABI only (loaded via ctypes).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>
#include <vector>

namespace {

double l_of(double r, double rt) {
    double v = r * r - rt * rt;
    return v > 0.0 ? std::sqrt(v) : 0.0;
}

// Exact 2-entry OD weights for a segment inside one shell: for extinction
// linear in radius, int k dl is analytic via
// F(l) = (l r(l) + rt^2 asinh(l/rt)) / 2 (mirrors rt/raytrace.py
// _exact_shell_weights).
void exact_shell_weights(double l0, double l1, double rt, double r_lo,
                         double r_hi, double* w_lo, double* w_hi) {
    double dl = l1 - l0;
    *w_lo = 0.0;
    *w_hi = 0.0;
    if (dl <= 0.0) return;
    auto F = [rt](double l) {
        double r = std::sqrt(rt * rt + l * l);
        if (rt > 0.0) return 0.5 * (l * r + rt * rt * std::asinh(l / rt));
        return 0.5 * l * std::abs(l);
    };
    double i_r = F(l1) - F(l0);
    double dr = r_hi - r_lo;
    if (dr <= 0.0) { *w_lo = dl; return; }
    double wh = (i_r - r_lo * dl) / dr;
    wh = std::max(0.0, std::min(wh, dl));
    *w_hi = wh;
    *w_lo = dl - wh;
}

int lower_level(const double* radii, int A, double r) {
    // index j with radii[j] <= r < radii[j+1], clamped to [0, A-2]
    int lo = 0, hi = A - 1;
    if (r <= radii[0]) return 0;
    if (r >= radii[A - 1]) return A - 2;
    while (hi - lo > 1) {
        int mid = (lo + hi) / 2;
        if (radii[mid] <= r) lo = mid; else hi = mid;
    }
    return std::min(lo, A - 2);
}

void interp_weights(const double* radii, int A, double r, double* row) {
    std::memset(row, 0, sizeof(double) * A);
    if (r <= radii[0]) { row[0] = 1.0; return; }
    if (r >= radii[A - 1]) { row[A - 1] = 1.0; return; }
    int j = lower_level(radii, A, r);
    double f = (r - radii[j]) / (radii[j + 1] - radii[j]);
    row[j] = 1.0 - f;
    row[j + 1] = f;
}

// OD-to-sun weights: walk shells from radius r toward the sun
void sun_od_weights(const double* radii, int A, double earth_radius,
                    double r, double cos_sza, double* row) {
    std::memset(row, 0, sizeof(double) * A);
    double sin_sza = std::sqrt(std::max(1.0 - cos_sza * cos_sza, 0.0));
    double rt = r * sin_sza;
    if (cos_sza < 0.0 && rt <= earth_radius) {
        row[0] = 1e10;
        return;
    }
    auto leg = [&](double r_from, double r_to) {
        int jf = lower_level(radii, A, r_from);
        int jt = lower_level(radii, A, r_to);
        double r0 = r_from;
        for (int j = jf; j <= jt; ++j) {
            double r1 = std::min(radii[j + 1], r_to);
            if (r1 <= r0) continue;
            double wl, wh;
            exact_shell_weights(l_of(r0, rt), l_of(r1, rt), rt,
                                radii[j], radii[j + 1], &wl, &wh);
            row[j] += wl;
            row[j + 1] += wh;
            r0 = r1;
        }
    };
    if (cos_sza >= 0.0) {
        leg(r, radii[A - 1]);
    } else {
        double rlow = std::max(rt, radii[0]);
        leg(rlow, r);
        leg(rlow, radii[A - 1]);
    }
}

struct SolarPoint { double cs, cz, relazi; };

SolarPoint solar_at_point(double s_dist, double r_ref, double coszen_ref,
                          const double* sun_vec) {
    double sz_ref = std::sqrt(std::max(1.0 - coszen_ref * coszen_ref, 0.0));
    double p_hat[3] = {sz_ref, 0.0, coszen_ref};
    double r_vec[3] = {s_dist * p_hat[0], s_dist * p_hat[1],
                       r_ref + s_dist * p_hat[2]};
    double r = std::sqrt(r_vec[0] * r_vec[0] + r_vec[1] * r_vec[1] +
                         r_vec[2] * r_vec[2]);
    double r_hat[3] = {r_vec[0] / r, r_vec[1] / r, r_vec[2] / r};
    double cs = sun_vec[0] * r_hat[0] + sun_vec[1] * r_hat[1] +
                sun_vec[2] * r_hat[2];
    double cz = p_hat[0] * r_hat[0] + p_hat[2] * r_hat[2];
    double szl = std::sqrt(std::max(1.0 - cz * cz, 0.0));
    double ssl = std::sqrt(std::max(1.0 - cs * cs, 0.0));
    double relazi = 0.0;
    if (szl * ssl >= 1e-12) {
        // signed relative azimuth (matches the python tracer): atan2 of the
        // sun along (h_hat, r_hat x h_hat); sign only matters for Stokes U
        double h_hat[3] = {(p_hat[0] - cz * r_hat[0]) / szl,
                           (-cz * r_hat[1]) / szl,
                           (p_hat[2] - cz * r_hat[2]) / szl};
        double y_hat[3] = {r_hat[1] * h_hat[2] - r_hat[2] * h_hat[1],
                           r_hat[2] * h_hat[0] - r_hat[0] * h_hat[2],
                           r_hat[0] * h_hat[1] - r_hat[1] * h_hat[0]};
        double sy = sun_vec[0] * y_hat[0] + sun_vec[1] * y_hat[1] +
                    sun_vec[2] * y_hat[2];
        double sh = sun_vec[0] * h_hat[0] + sun_vec[1] * h_hat[1] +
                    sun_vec[2] * h_hat[2];
        relazi = std::atan2(sy, sh);
    }
    return {cs, cz, relazi};
}

double scatter_cosine(double cz, double cs, double relazi) {
    double szl = std::sqrt(std::max(1.0 - cz * cz, 0.0));
    double ssl = std::sqrt(std::max(1.0 - cs * cs, 0.0));
    return -cz * cs - szl * ssl * std::cos(relazi);
}

struct Tables {
    double *od_w, *sun_w, *int_w, *lengths, *mask;
    double *cos_scat, *cos_zen, *cos_sza_b;
    int64_t *seg_layer;
    double *seg_in_frac, *seg_out_frac, *b_relazi;
    int A, S;
};

void fill_boundary(Tables& T, const double* radii, double re, int ri, int b,
                   double r, double s_dist, double r_ref, double coszen_ref,
                   const double* sun_vec) {
    int A = T.A, S = T.S;
    SolarPoint sp = solar_at_point(s_dist, r_ref, coszen_ref, sun_vec);
    T.cos_zen[ri * (S + 1) + b] = sp.cz;
    T.cos_sza_b[ri * (S + 1) + b] = sp.cs;
    T.cos_scat[ri * (S + 1) + b] = scatter_cosine(sp.cz, sp.cs, sp.relazi);
    T.b_relazi[ri * (S + 1) + b] = sp.relazi;
    interp_weights(radii, A, r, &T.int_w[(ri * (S + 1) + b) * A]);
    sun_od_weights(radii, A, re, r, sp.cs, &T.sun_w[(ri * (S + 1) + b) * A]);
}

}  // namespace

extern "C" {

// ray_kind: 0 = limb (params: tangent_radius, cos_sza, relazi)
//           1 = ground-viewing downward (params: mu_abs, cos_sza, relazi)
//           2 = upward-looking from ground (params: mu_abs, cos_sza, relazi)
void sk_trace_rays(
    const double* radii, int A, double earth_radius,
    const int* kinds, const double* params /* [R, 3] */, int R,
    // outputs (pre-zeroed by caller):
    double* od_w /* [R, S, A] */, double* sun_w /* [R, S+1, A] */,
    double* int_w /* [R, S+1, A] */, double* lengths /* [R, S] */,
    double* mask /* [R, S] */, double* cos_scat /* [R, S+1] */,
    double* cos_zen /* [R, S+1] */, double* cos_sza_b /* [R, S+1] */,
    int64_t* seg_layer /* [R, S] */, double* seg_in_frac /* [R, S] */,
    double* seg_out_frac /* [R, S] */, double* b_relazi /* [R, S+1] */,
    unsigned char* ground_hit /* [R] */, double* ground_cos_sza /* [R] */,
    double* ground_cos_vza /* [R] */, double* ground_relazi /* [R] */) {
    int S = 2 * (A - 1);
    int P = A - 1;
    Tables T{od_w, sun_w, int_w, lengths, mask, cos_scat, cos_zen,
             cos_sza_b, seg_layer, seg_in_frac, seg_out_frac, b_relazi,
             A, S};
    std::vector<double> tmp(A);

    for (int ri = 0; ri < R; ++ri) {
        int kind = kinds[ri];
        double p0 = params[ri * 3 + 0];
        double cs0 = params[ri * 3 + 1];
        double relazi = params[ri * 3 + 2];
        double ss0 = std::sqrt(std::max(1.0 - cs0 * cs0, 0.0));
        double sun_vec[3] = {ss0 * std::cos(relazi), ss0 * std::sin(relazi),
                             cs0};

        if (kind == 0) {
            // limb: p0 = tangent radius
            double rt = p0;
            int jt = 0;
            while (jt < A && radii[jt] < rt) ++jt;  // first level above rt
            // boundary radii: TOA down to level jt, tangent, back to TOA
            std::vector<double> bounds;
            std::vector<double> signs;
            for (int j = A - 1; j >= jt; --j) bounds.push_back(radii[j]);
            bounds.push_back(rt);
            for (int j = jt; j <= A - 1; ++j) bounds.push_back(radii[j]);
            int ndesc = A - jt;
            int s_out = 0;
            for (size_t s = 0; s + 1 < bounds.size(); ++s) {
                double r0 = bounds[s], r1 = bounds[s + 1];
                double lo = std::min(r0, r1), hi = std::max(r0, r1);
                double ds = l_of(hi, rt) - l_of(lo, rt);
                if (ds <= 0.0) continue;
                bool descending = s + 1 <= (size_t)ndesc;
                double sign = descending ? -1.0 : 1.0;
                double rm = 0.5 * (lo + hi);
                int jlev = lower_level(radii, A, rm);
                double wl, wh;
                exact_shell_weights(l_of(lo, rt), l_of(hi, rt), rt,
                                    radii[jlev], radii[jlev + 1], &wl, &wh);
                od_w[(ri * S + s_out) * A + jlev] = wl;
                od_w[(ri * S + s_out) * A + jlev + 1] = wh;
                lengths[ri * S + s_out] = ds;
                mask[ri * S + s_out] = 1.0;
                seg_layer[ri * S + s_out] = (P - 1) - jlev;
                double dz = radii[jlev + 1] - radii[jlev];
                double fin = (radii[jlev + 1] - r0) / dz;
                double fout = (radii[jlev + 1] - r1) / dz;
                seg_in_frac[ri * S + s_out] =
                    std::max(0.0, std::min(1.0, fin));
                seg_out_frac[ri * S + s_out] =
                    std::max(0.0, std::min(1.0, fout));
                double sb = (s <= (size_t)ndesc - 1 && descending) ? -1.0 : 1.0;
                double s_dist = sb * l_of(r0, rt);
                // entrance boundary of this segment
                fill_boundary(T, radii, earth_radius, ri, s_out, r0, s_dist,
                              rt, 0.0, sun_vec);
                s_out += 1;
            }
            // observer-side boundary (TOA, ascending)
            fill_boundary(T, radii, earth_radius, ri, s_out, bounds.back(),
                          l_of(bounds.back(), rt), rt, 0.0, sun_vec);
        } else {
            // nadir-type: p0 = |cos viewing zenith| at the ground point
            bool downward = (kind == 1);
            double mu_abs = p0;
            double r_ref = radii[0];
            double sinv = std::sqrt(std::max(1.0 - mu_abs * mu_abs, 0.0));
            double rt = r_ref * sinv;
            double coszen_ref = downward ? mu_abs : -mu_abs;
            double sz_ref = std::sqrt(std::max(1.0 - coszen_ref * coszen_ref,
                                               0.0));
            double sun2[3] = {ss0 * std::cos(relazi), ss0 * std::sin(relazi),
                              cs0};
            double l_ref = l_of(r_ref, rt);
            if (downward) {
                ground_hit[ri] = 1;
                ground_cos_sza[ri] = cs0;
                ground_cos_vza[ri] = mu_abs;
                ground_relazi[ri] = relazi;
            }
            for (int s = 0; s < P; ++s) {
                double lo = radii[s], hi = radii[s + 1];
                double ds = l_of(hi, rt) - l_of(lo, rt);
                int sidx = downward ? s : (P - 1 - s);
                double wl, wh;
                exact_shell_weights(l_of(lo, rt), l_of(hi, rt), rt, lo, hi,
                                    &wl, &wh);
                od_w[(ri * S + sidx) * A + s] = wl;
                od_w[(ri * S + sidx) * A + s + 1] = wh;
                lengths[ri * S + sidx] = ds;
                mask[ri * S + sidx] = 1.0;
                double br = downward ? lo : hi;
                double l_b = l_of(br, rt);
                double s_dist = downward ? (l_b - l_ref) : -(l_b - l_ref);
                fill_boundary(T, radii, earth_radius, ri, sidx, br, s_dist,
                              r_ref, coszen_ref, sun2);
                seg_layer[ri * S + sidx] = (P - 1) - s;
                seg_in_frac[ri * S + sidx] = downward ? 1.0 : 0.0;
                seg_out_frac[ri * S + sidx] = downward ? 0.0 : 1.0;
            }
            double br = downward ? radii[A - 1] : radii[0];
            double l_b = l_of(br, rt);
            double s_dist = downward ? (l_b - l_ref) : -(l_b - l_ref);
            fill_boundary(T, radii, earth_radius, ri, P, br, s_dist, r_ref,
                          coszen_ref, sun2);
        }
    }
}

}  // extern "C"
