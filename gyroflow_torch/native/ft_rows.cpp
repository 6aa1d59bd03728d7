// The FrameTransform's per-row table in one pass (ops/frame_transform.py).
//
// First the frame's two quaternions: the inverse of the integrated one and
// the smoothed one at the frame's time. Then for each row: its capture time,
// the gyro-offset adjusted and rounded lookup, the upper-bound search in the
// integrated quaternions, the slerp between the bracketing samples
// (nalgebra semantics: no hemisphere flip, nlerp fallback), the two Hamilton
// products with the frame's quaternions, the rotation matrix, the image
// rotation, the sign fix-up and the product with the inverse of new_k; then
// the IBIS and OIS Catmull-Rom shifts at the row's sensor line. Output:
// (rows, 14) float32, the layout of frame_transform_at's ``matrices``.
//
// Every expression is written in the order numpy evaluates its twin in
// ops/frame_transform.py (sums start at +0 as np.einsum's do), and the file
// is built with -ffp-contract=off and without fast math, so that each
// float64 product and sum rounds as numpy's does. acos, sin and pow are
// libm's: numpy's SIMD versions may differ from them in the last float64
// bit, which the float32 table does not show (tests/test_torch_ft_rows.py).
//
// Quaternion layout: (w, x, y, z) f64, matching core/quaternion.py.

#include <algorithm>
#include <cmath>
#include <cstdint>

namespace {

// GyroSource._offset_at / time_quat.interp_series (clamp_inner=True)
double offset_at(const int64_t* ks, const double* vs, int64_t n, double t) {
    if (n == 0) return 0.0;
    if (n == 1) return vs[0];
    const int64_t ts_us = static_cast<int64_t>(t * 1000.0);
    const int64_t lookup = std::min(std::max(ts_us, ks[0] + 1), ks[n - 1] - 1);
    int64_t i1 = (std::upper_bound(ks, ks + n, lookup) - ks) - 1;
    i1 = std::min(std::max(i1, int64_t(0)), n - 2);
    const int64_t t1 = ks[i1], t2 = ks[i1 + 1];
    if (t1 == lookup) return vs[i1];
    double delta = static_cast<double>(t2 - t1);
    if (delta == 0.0) delta = 1.0;
    const double frac = static_cast<double>(ts_us - t1) / delta;
    return vs[i1] + (vs[i1 + 1] - vs[i1]) * frac;
}

// TimeQuat.at_timestamp (quaternion.slerp between the bracketing samples),
// at a time already offset-adjusted (ms). The slerp's angle depends on the
// bracket alone, and a frame's rows mostly share one: it is kept.
struct Series {
    const int64_t* ts;
    const double* quats;
    int64_t n;
    int64_t bracket = -1;
    double theta = 0.0, sin_theta = 0.0;

    void at(double t_ms, double* out) {
        if (n < 2) {
            out[0] = 1.0;
            out[1] = out[2] = out[3] = 0.0;
            return;
        }
        int64_t lookup = static_cast<int64_t>(std::nearbyint(t_ms * 1000.0));
        lookup = std::min(std::max(lookup, ts[0]), ts[n - 1]);
        int64_t i1 = bracket;   // the last bracket, if it holds the lookup
        if (i1 < 0 || lookup < ts[i1] || lookup >= ts[i1 + 1]) {
            i1 = (std::upper_bound(ts, ts + n, lookup) - ts) - 1;
            i1 = std::min(std::max(i1, int64_t(0)), n - 2);
        }
        const int64_t t1 = ts[i1], t2 = ts[i1 + 1];
        double delta = static_cast<double>(t2 - t1);
        if (delta == 0.0) delta = 1.0;
        double t = static_cast<double>(lookup - t1) / delta;
        if (t1 == lookup) t = 0.0;
        const double* a = quats + 4 * i1;
        const double* b = a + 4;
        if (i1 != bracket) {
            double d = ((a[0] * b[0] + a[1] * b[1]) + a[2] * b[2]) + a[3] * b[3];
            d = std::min(std::max(d, -1.0), 1.0);
            theta = std::acos(d);
            sin_theta = std::sin(theta);
            bracket = i1;
        }
        double wa, wb;
        if (std::fabs(sin_theta) < 1e-9) {
            wa = 1.0 - t;
            wb = t;
        } else {
            wa = std::sin((1.0 - t) * theta) / sin_theta;
            wb = std::sin(t * theta) / sin_theta;
        }
        double q[4];
        for (int i = 0; i < 4; i++) q[i] = a[i] * wa + b[i] * wb;
        double norm = std::sqrt(((q[0] * q[0] + q[1] * q[1]) + q[2] * q[2]) + q[3] * q[3]);
        if (norm == 0.0) norm = 1.0;
        for (int i = 0; i < 4; i++) out[i] = q[i] / norm;
    }
};

// quaternion.multiply: the Hamilton product a*b
void multiply(const double* a, const double* b, double* out) {
    const double aw = a[0], ax = a[1], ay = a[2], az = a[3];
    const double bw = b[0], bx = b[1], by = b[2], bz = b[3];
    out[0] = aw * bw - ax * bx - ay * by - az * bz;
    out[1] = aw * bx + ax * bw + ay * bz - az * by;
    out[2] = aw * by - ax * bz + ay * bw + az * bx;
    out[3] = aw * bz + ax * by - ay * bx + az * bw;
}

// quaternion.to_rotation_matrix, row-major
void rotation_matrix(const double* q, double* m) {
    const double w = q[0], x = q[1], y = q[2], z = q[3];
    const double xx = x * x, yy = y * y, zz = z * z;
    const double xy = x * y, xz = x * z, yz = y * z;
    const double wx = w * x, wy = w * y, wz = w * z;
    m[0] = 1 - 2 * (yy + zz);
    m[1] = 2 * (xy - wz);
    m[2] = 2 * (xz + wy);
    m[3] = 2 * (xy + wz);
    m[4] = 1 - 2 * (xx + zz);
    m[5] = 2 * (yz - wx);
    m[6] = 2 * (xz - wy);
    m[7] = 2 * (yz + wx);
    m[8] = 1 - 2 * (xx + yy);
}

// splines.CatmullRom.interpolate at one position, its first cols columns of
// dim; zeros outside the points
void catmull_rom(const double* pos, const double* vals, int64_t n, int64_t dim, int cols,
                 double t, double* out) {
    for (int c = 0; c < cols; c++) out[c] = 0.0;
    if (n < 2) return;
    const int64_t lower = (std::upper_bound(pos, pos + n, t) - pos) - 1;
    if (lower < 0 || lower + 1 >= n) return;
    const int64_t li = lower;
    const double p0 = pos[li], p1 = pos[li + 1];
    const double k = (t - p0) / (p1 == p0 ? 1.0 : p1 - p0);
    const double k2 = k * k, k3 = std::pow(k, 3.0);
    for (int c = 0; c < cols; c++) {
        const double a = vals[li * dim + c], b = vals[(li + 1) * dim + c];
        const double x = li <= 0 ? a * 2.0 - b : vals[(li - 1) * dim + c];
        const double y = li + 2 >= n ? b * 2.0 - a : vals[(li + 2) * dim + c];
        out[c] = ((((a * 3.0 - x) - b * 3.0) + y) * 0.5) * k3
            + ((b - x) * 0.5) * k
            + a
            + (((b * 4.0 + a * -5.0 + x + x) - y) * 0.5) * k2;
    }
}

// out[i][k] = sum_j a[j][i] * b[j][k] (aT @ b) or a[i][j] * b[j][k] (a @ b), from +0
void matmul3(const double* a, const double* b, bool transpose_a, double* out) {
    for (int i = 0; i < 3; i++)
        for (int k = 0; k < 3; k++) {
            double s = 0.0;
            for (int j = 0; j < 3; j++) s += (transpose_a ? a[j * 3 + i] : a[i * 3 + j]) * b[j * 3 + k];
            out[i * 3 + k] = s;
        }
}

}  // namespace

extern "C" {

// frame: ts (the frame's time, ms), start_ts, row_readout_time, per_row (0:
//        every row at start_ts), framebuffer_inverted, suppress_rotation,
//        height, then the IBIS constants: has_stab, zero_ibis, crop_y,
//        crop_h, sensor_h, offset, is_scale_x, is_scale_y, angle_sign
// consts: image_rotation (3x3), inv_k (3x3)
// offsets: the gyro offsets (us keys, ms values), sorted by key
// org, smoothed: the integrated and the smoothed quaternions (us, (n, 4));
//        n < 2 reads identity
// ibis / ois: spline positions and (n, dim) values, dim >= 3 / >= 2
void gf_ft_rows(int64_t rows, const double* frame, const double* consts,
                const int64_t* off_us, const double* off_ms, int64_t n_off,
                const int64_t* org_us, const double* org_q, int64_t n_org,
                const int64_t* sm_us, const double* sm_q, int64_t n_sm,
                const double* ibis_pos, const double* ibis_vals, int64_t n_ibis, int64_t ibis_dim,
                const double* ois_pos, const double* ois_vals, int64_t n_ois, int64_t ois_dim,
                float* out) {
    const double ts = frame[0], start_ts = frame[1], row_readout_time = frame[2];
    const bool per_row = frame[3] != 0.0, inverted = frame[4] != 0.0;
    const bool suppress = frame[5] != 0.0;
    const double height = frame[6];
    const bool has_stab = frame[7] != 0.0, zero_ibis = frame[8] != 0.0;
    const double crop_y = frame[9], crop_h = frame[10], sensor_h = frame[11];
    const double stab_offset = frame[12], is_x = frame[13], is_y = frame[14];
    const double angle_sign = frame[15];
    const double* image_rotation = consts;
    const double* inv_k = consts + 9;
    static const double eye[9] = {1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0};
    const double deg2rad = M_PI / 180.0;

    Series org{org_us, org_q, n_org}, smoothed{sm_us, sm_q, n_sm};
    // quat1 = inverse(org at ts), smoothed_quat1 = smoothed at ts
    double quat1[4], smoothed_quat1[4];
    const double ts_adj = ts - offset_at(off_us, off_ms, n_off, ts);
    org.at(ts_adj, quat1);
    for (int i = 1; i < 4; i++) quat1[i] *= -1.0;
    smoothed.at(ts_adj, smoothed_quat1);

    for (int64_t row = 0; row < rows; row++) {
        const double ys = static_cast<double>(row);
        double r[9];
        if (suppress) {
            std::copy(eye, eye + 9, r);
        } else {
            const double t = per_row ? start_ts + row_readout_time * ys : start_ts;
            const double adj = t - offset_at(off_us, off_ms, n_off, t);
            double rq[4], q1[4], q[4], m[9];
            org.at(adj, rq);
            multiply(quat1, rq, q1);
            multiply(smoothed_quat1, q1, q);
            rotation_matrix(q, m);
            matmul3(image_rotation, m, false, r);
            if (inverted) {
                r[2] *= -1.0; r[5] *= -1.0; r[6] *= -1.0; r[7] *= -1.0;
            } else {
                r[1] *= -1.0; r[2] *= -1.0; r[3] *= -1.0; r[6] *= -1.0;
            }
        }
        double i_r[9];
        matmul3(r, inv_k, true, i_r);
        float* o = out + row * 14;
        for (int i = 0; i < 9; i++) o[i] = static_cast<float>(i_r[i]);

        double ibis[5] = {0.0, 0.0, 0.0, 0.0, 0.0};
        if (has_stab && !zero_ibis) {
            double y_sensor = crop_y + (ys / height) * crop_h;
            if (inverted) y_sensor = sensor_h - y_sensor;
            const double at = y_sensor + stab_offset;
            double s[3], ois[2];
            catmull_rom(ibis_pos, ibis_vals, n_ibis, ibis_dim, 3, at, s);
            catmull_rom(ois_pos, ois_vals, n_ois, ois_dim, 2, at, ois);
            ibis[0] = s[0] * is_x;
            ibis[1] = s[1] * is_y;
            ibis[2] = (s[2] / 1000.0 * angle_sign) * deg2rad;
            ibis[3] = ois[0] * is_x;
            ibis[4] = ois[1] * is_y;
        }
        for (int i = 0; i < 5; i++) o[9 + i] = static_cast<float>(ibis[i]);
    }
}

}  // extern "C"
