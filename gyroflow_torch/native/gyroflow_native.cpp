// Native hot loops for the host-side orientation engine.
//
// The smoothing slerp-EMA chains and the VQF filter are inherently sequential
// scans over ~1kHz x minutes of samples (default_algo.rs:338-387, vqf.rs) —
// the only parts of the rebuilt engine where Python-loop overhead matters.
// Compiled at import time by gyroflow_tpu.native (ctypes); every function has
// a Python fallback with identical semantics (tested for equality).
//
// Quaternion layout: (w, x, y, z) f64, matching core/quaternion.py.

#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------------
// slerp (nalgebra semantics: no hemisphere flip, nlerp fallback)
// ---------------------------------------------------------------------------

static void slerp1(const double* a, const double* b, double t, double* out) {
    double d = a[0]*b[0] + a[1]*b[1] + a[2]*b[2] + a[3]*b[3];
    if (d > 1.0) d = 1.0;
    if (d < -1.0) d = -1.0;
    double theta = std::acos(d);
    double s = std::sin(theta);
    double wa, wb;
    if (std::fabs(s) < 1e-9) {
        wa = 1.0 - t;
        wb = t;
    } else {
        wa = std::sin((1.0 - t) * theta) / s;
        wb = std::sin(t * theta) / s;
    }
    double q0 = a[0]*wa + b[0]*wb;
    double q1 = a[1]*wa + b[1]*wb;
    double q2 = a[2]*wa + b[2]*wb;
    double q3 = a[3]*wa + b[3]*wb;
    double n = std::sqrt(q0*q0 + q1*q1 + q2*q2 + q3*q3);
    if (n == 0.0) n = 1.0;
    out[0] = q0/n; out[1] = q1/n; out[2] = q2/n; out[3] = q3/n;
}

// q = slerp(q, x[i], alpha[i]) scan, in place; first element kept
void slerp_scan(double* quats, int64_t n, const double* alphas, int reverse) {
    if (n == 0) return;
    double q[4];
    if (reverse) {
        std::memcpy(q, quats + 4*(n-1), 4*sizeof(double));
        for (int64_t i = n-2; i >= 0; i--) {
            slerp1(q, quats + 4*i, alphas[i], q);
            std::memcpy(quats + 4*i, q, 4*sizeof(double));
        }
    } else {
        std::memcpy(q, quats, 4*sizeof(double));
        for (int64_t i = 1; i < n; i++) {
            slerp1(q, quats + 4*i, alphas[i], q);
            std::memcpy(quats + 4*i, q, 4*sizeof(double));
        }
    }
}

// v[i] = v[prev]*(1-a[i]) + v[i]*a[i] scan over (n, c) array, in place
void ema_scan(double* vals, int64_t n, int64_t c, const double* alphas, int reverse) {
    if (n == 0) return;
    if (reverse) {
        for (int64_t i = n-2; i >= 0; i--) {
            double a = alphas[i];
            for (int64_t k = 0; k < c; k++)
                vals[i*c+k] = vals[(i+1)*c+k]*(1.0-a) + vals[i*c+k]*a;
        }
    } else {
        for (int64_t i = 1; i < n; i++) {
            double a = alphas[i];
            for (int64_t k = 0; k < c; k++)
                vals[i*c+k] = vals[(i-1)*c+k]*(1.0-a) + vals[i*c+k]*a;
        }
    }
}

// ---------------------------------------------------------------------------
// per-axis scan (default_algo.rs per_axis branches)
// ---------------------------------------------------------------------------

static void quat_mul(const double* a, const double* b, double* out) {
    double w = a[0]*b[0] - a[1]*b[1] - a[2]*b[2] - a[3]*b[3];
    double x = a[0]*b[1] + a[1]*b[0] + a[2]*b[3] - a[3]*b[2];
    double y = a[0]*b[2] - a[1]*b[3] + a[2]*b[0] + a[3]*b[1];
    double z = a[0]*b[3] + a[1]*b[2] - a[2]*b[1] + a[3]*b[0];
    out[0]=w; out[1]=x; out[2]=y; out[3]=z;
}

// euler (roll_x, pitch_y, yaw_z) with R = Rz yaw * Ry pitch * Rx roll
static void euler_of(const double* q, double* rpy) {
    double w=q[0], x=q[1], y=q[2], z=q[3];
    double m20 = 2.0*(x*z - w*y);
    if (m20 > 1.0) m20 = 1.0;
    if (m20 < -1.0) m20 = -1.0;
    double m21 = 2.0*(y*z + w*x);
    double m22 = 1.0 - 2.0*(x*x + y*y);
    double m10 = 2.0*(x*y + w*z);
    double m00 = 1.0 - 2.0*(y*y + z*z);
    if (std::fabs(m20) >= 1.0 - 1e-12) {
        double m12 = 2.0*(y*z - w*x);
        double m11 = 1.0 - 2.0*(x*x + z*z);
        rpy[0] = std::atan2(-m12, m11);
        rpy[1] = (m20 < 0) ? M_PI/2 : -M_PI/2;
        rpy[2] = 0.0;
    } else {
        rpy[0] = std::atan2(m21, m22);
        rpy[1] = -std::asin(m20);
        rpy[2] = std::atan2(m10, m00);
    }
}

static void quat_from_axis_z(double angle, double* out) {
    out[0] = std::cos(angle/2); out[1] = 0; out[2] = 0; out[3] = std::sin(angle/2);
}

static void from_euler(double roll, double pitch, double yaw, double* out) {
    // Rz(yaw)*Ry(pitch)*Rx(roll)
    double cr = std::cos(roll/2), sr = std::sin(roll/2);
    double cp = std::cos(pitch/2), sp = std::sin(pitch/2);
    double cy = std::cos(yaw/2), sy = std::sin(yaw/2);
    double qx[4] = {cr, sr, 0, 0};
    double qy[4] = {cp, 0, sp, 0};
    double qz[4] = {cy, 0, 0, sy};
    double t[4];
    quat_mul(qy, qx, t);
    quat_mul(qz, t, out);
}

// q = q * from_euler(euler(q^-1 * x) * factors[i]) scan
void per_axis_scan(double* quats, int64_t n, const double* factors, int reverse) {
    if (n == 0) return;
    double q[4];
    int64_t start, step, count;
    if (reverse) { std::memcpy(q, quats + 4*(n-1), 4*sizeof(double)); start = n-2; step = -1; count = n-1; }
    else { std::memcpy(q, quats, 4*sizeof(double)); start = 1; step = 1; count = n-1; }
    for (int64_t c = 0; c < count; c++) {
        int64_t i = start + c*step;
        double qinv[4] = {q[0], -q[1], -q[2], -q[3]};
        double d[4];
        quat_mul(qinv, quats + 4*i, d);
        double rpy[3];
        euler_of(d, rpy);
        double rot[4];
        from_euler(rpy[0]*factors[3*i+0], rpy[1]*factors[3*i+1], rpy[2]*factors[3*i+2], rot);
        double nq[4];
        quat_mul(q, rot, nq);
        double nn = std::sqrt(nq[0]*nq[0]+nq[1]*nq[1]+nq[2]*nq[2]+nq[3]*nq[3]);
        if (nn == 0.0) nn = 1.0;
        for (int k = 0; k < 4; k++) q[k] = nq[k]/nn;
        std::memcpy(quats + 4*i, q, 4*sizeof(double));
    }
}

// ---------------------------------------------------------------------------
// VQF realtime + offline (port of gyroflow_tpu/core/imu_integration/vqf.py,
// itself a port of imu_integration/vqf.rs)
// ---------------------------------------------------------------------------

static const double VEPS = 2.220446049250313e-16;
static const double D2R = M_PI / 180.0;

struct VQFP {
    double tau_acc, bias_sigma_init, bias_forgetting_time, bias_clip;
    double bias_sigma_motion, bias_vertical_forgetting_factor, bias_sigma_rest;
    double rest_min_t, rest_filter_tau, rest_th_gyr, rest_th_acc;
    int motion_bias_est, rest_bias_est;
};

static void fcoeffs(double tau, double ts, double* b, double* a) {
    double fc = (M_SQRT2 / (2.0*M_PI)) / tau;
    double c = std::tan(M_PI*fc*ts);
    double d = c*c + M_SQRT2*c + 1.0;
    double b0 = c*c/d;
    b[0]=b0; b[1]=2*b0; b[2]=b0;
    a[0] = 2.0*(c*c-1.0)/d;
    a[1] = (1.0-M_SQRT2*c+c*c)/d;
}

static void finit(double x0, const double* b, const double* a, double* st) {
    st[0] = x0*(1.0-b[0]);
    st[1] = x0*(b[2]-a[1]);
}

static double fstep(double x, const double* b, const double* a, double* st) {
    double y = b[0]*x + st[0];
    st[0] = b[1]*x - a[0]*y + st[1];
    st[1] = b[2]*x - a[1]*y;
    return y;
}

static void fvec(const double* x, int n, double tau, double ts, const double* b,
                 const double* a, double* state, double* out) {
    if (std::isnan(state[0])) {
        if (std::isnan(state[1])) {
            state[1] = 0.0;
            for (int i = 0; i < n; i++) state[2+i] = 0.0;
        }
        state[1] += 1.0;
        for (int i = 0; i < n; i++) {
            state[2+i] += x[i];
            out[i] = state[2+i]/state[1];
        }
        if (state[1]*ts >= tau)
            for (int i = 0; i < n; i++) finit(out[i], b, a, state + 2*i);
        return;
    }
    for (int i = 0; i < n; i++) out[i] = fstep(x[i], b, a, state + 2*i);
}

static void m3mul(const double* m1, const double* m2, double* o) {
    double r[9];
    for (int i = 0; i < 3; i++)
        for (int j = 0; j < 3; j++)
            r[i*3+j] = m1[i*3]*m2[j] + m1[i*3+1]*m2[3+j] + m1[i*3+2]*m2[6+j];
    std::memcpy(o, r, sizeof(r));
}

static void m3mul_t1(const double* m1, const double* m2, double* o) {
    double r[9];
    for (int i = 0; i < 3; i++)
        for (int j = 0; j < 3; j++)
            r[i*3+j] = m1[i]*m2[j] + m1[3+i]*m2[3+j] + m1[6+i]*m2[6+j];
    std::memcpy(o, r, sizeof(r));
}

static void m3mul_t2(const double* m1, const double* m2, double* o) {
    double r[9];
    for (int i = 0; i < 3; i++)
        for (int j = 0; j < 3; j++)
            r[i*3+j] = m1[i*3]*m2[j*3] + m1[i*3+1]*m2[j*3+1] + m1[i*3+2]*m2[j*3+2];
    std::memcpy(o, r, sizeof(r));
}

static void m3inv(const double* m, double* o) {
    double a = m[4]*m[8]-m[5]*m[7], d = m[2]*m[7]-m[1]*m[8], g = m[1]*m[5]-m[2]*m[4];
    double b = m[5]*m[6]-m[3]*m[8], e = m[0]*m[8]-m[2]*m[6], h = m[2]*m[3]-m[0]*m[5];
    double c = m[3]*m[7]-m[4]*m[6], f = m[1]*m[6]-m[0]*m[7], i = m[0]*m[4]-m[1]*m[3];
    double det = m[0]*a + m[1]*b + m[2]*c;
    if (det >= -VEPS && det <= VEPS) { std::memset(o, 0, 9*sizeof(double)); return; }
    o[0]=a/det; o[1]=d/det; o[2]=g/det; o[3]=b/det; o[4]=e/det;
    o[5]=h/det; o[6]=c/det; o[7]=f/det; o[8]=i/det;
}

static void qrot(const double* q, const double* v, double* o) {
    o[0] = (1-2*q[2]*q[2]-2*q[3]*q[3])*v[0] + 2*v[1]*(q[2]*q[1]-q[0]*q[3]) + 2*v[2]*(q[0]*q[2]+q[3]*q[1]);
    o[1] = 2*v[0]*(q[0]*q[3]+q[2]*q[1]) + v[1]*(1-2*q[1]*q[1]-2*q[3]*q[3]) + 2*v[2]*(q[2]*q[3]-q[1]*q[0]);
    o[2] = 2*v[0]*(q[3]*q[1]-q[0]*q[2]) + 2*v[1]*(q[0]*q[1]+q[3]*q[2]) + v[2]*(1-2*q[1]*q[1]-2*q[2]*q[2]);
}

static void qnorm(double* q, int n) {
    double l = 0;
    for (int i = 0; i < n; i++) l += q[i]*q[i];
    l = std::sqrt(l);
    if (l < VEPS) return;
    for (int i = 0; i < n; i++) q[i] /= l;
}

struct VQFState {
    double gyr_quat[4], acc_quat[4];
    int rest_detected;
    double last_acc_lp[3], acc_lp_state[8];
    double bias[3], bias_p[9];
    double mb_r_lp_state[20], mb_bias_lp_state[6];
    double rest_sq_dev[2], rest_t;
    double rest_last_gyr_lp[3], rest_gyr_lp_state[8];
    double rest_last_acc_lp[3], rest_acc_lp_state[8];
};

struct VQFFilter {
    VQFP p;
    double gyr_ts, acc_ts;
    double acc_lp_b[3], acc_lp_a[2];
    double bias_p0, bias_v, bias_motion_w, bias_vertical_w, bias_rest_w;
    double rg_b[3], rg_a[2], ra_b[3], ra_a[2];
    VQFState s;
};

static void vqf_reset(VQFFilter* f) {
    VQFState* s = &f->s;
    std::memset(s, 0, sizeof(VQFState));
    s->gyr_quat[0] = 1.0; s->acc_quat[0] = 1.0;
    for (int i = 0; i < 8; i++) { s->acc_lp_state[i] = NAN; s->rest_gyr_lp_state[i] = NAN; s->rest_acc_lp_state[i] = NAN; }
    for (int i = 0; i < 20; i++) s->mb_r_lp_state[i] = NAN;
    for (int i = 0; i < 6; i++) s->mb_bias_lp_state[i] = NAN;
    for (int i = 0; i < 3; i++) s->rest_last_gyr_lp[i] = NAN;
    s->bias_p[0] = s->bias_p[4] = s->bias_p[8] = f->bias_p0;
}

static void vqf_init(VQFFilter* f, const VQFP* p, double ts) {
    f->p = *p;
    f->gyr_ts = ts;
    f->acc_ts = ts;
    fcoeffs(p->tau_acc, ts, f->acc_lp_b, f->acc_lp_a);
    f->bias_p0 = (p->bias_sigma_init*100.0)*(p->bias_sigma_init*100.0);
    f->bias_v = (0.1*100.0)*(0.1*100.0)*ts/p->bias_forgetting_time;
    double pm = (p->bias_sigma_motion*100.0)*(p->bias_sigma_motion*100.0);
    f->bias_motion_w = pm*pm/f->bias_v + pm;
    double vf = p->bias_vertical_forgetting_factor;
    f->bias_vertical_w = f->bias_motion_w / (vf > 1e-10 ? vf : 1e-10);
    double pr = (p->bias_sigma_rest*100.0)*(p->bias_sigma_rest*100.0);
    f->bias_rest_w = pr*pr/f->bias_v + pr;
    fcoeffs(p->rest_filter_tau, ts, f->rg_b, f->rg_a);
    fcoeffs(p->rest_filter_tau, ts, f->ra_b, f->ra_a);
    vqf_reset(f);
}

static void vqf_update(VQFFilter* f, const double* gyr, const double* acc) {
    VQFP* p = &f->p;
    VQFState* s = &f->s;

    // ---- gyr ----
    if (p->rest_bias_est) {
        fvec(gyr, 3, p->rest_filter_tau, f->gyr_ts, f->rg_b, f->rg_a, s->rest_gyr_lp_state, s->rest_last_gyr_lp);
        double* lp = s->rest_last_gyr_lp;
        s->rest_sq_dev[0] = (gyr[0]-lp[0])*(gyr[0]-lp[0]) + (gyr[1]-lp[1])*(gyr[1]-lp[1]) + (gyr[2]-lp[2])*(gyr[2]-lp[2]);
        double bclip = p->bias_clip * D2R;
        double th = p->rest_th_gyr * D2R;
        if (s->rest_sq_dev[0] >= th*th || std::fabs(lp[0]) > bclip || std::fabs(lp[1]) > bclip || std::fabs(lp[2]) > bclip) {
            s->rest_t = 0.0;
            s->rest_detected = 0;
        }
    }
    double g[3] = {gyr[0]-s->bias[0], gyr[1]-s->bias[1], gyr[2]-s->bias[2]};
    double gn = std::sqrt(g[0]*g[0]+g[1]*g[1]+g[2]*g[2]);
    if (gn > VEPS) {
        double angle = gn * f->gyr_ts;
        double c = std::cos(angle/2), sn = std::sin(angle/2)/gn;
        double dq[4] = {c, sn*g[0], sn*g[1], sn*g[2]};
        double nq[4];
        quat_mul(s->gyr_quat, dq, nq);
        std::memcpy(s->gyr_quat, nq, sizeof(nq));
        qnorm(s->gyr_quat, 4);
    }

    // ---- acc ----
    if (acc[0] == 0.0 && acc[1] == 0.0 && acc[2] == 0.0) return;
    if (p->rest_bias_est) {
        fvec(acc, 3, p->rest_filter_tau, f->acc_ts, f->ra_b, f->ra_a, s->rest_acc_lp_state, s->rest_last_acc_lp);
        double* lp = s->rest_last_acc_lp;
        s->rest_sq_dev[1] = (acc[0]-lp[0])*(acc[0]-lp[0]) + (acc[1]-lp[1])*(acc[1]-lp[1]) + (acc[2]-lp[2])*(acc[2]-lp[2]);
        if (s->rest_sq_dev[1] >= p->rest_th_acc*p->rest_th_acc) {
            s->rest_t = 0.0;
            s->rest_detected = 0;
        } else {
            s->rest_t += f->acc_ts;
            if (s->rest_t >= p->rest_min_t) s->rest_detected = 1;
        }
    }
    double acc_earth[3];
    qrot(s->gyr_quat, acc, acc_earth);
    fvec(acc_earth, 3, p->tau_acc, f->acc_ts, f->acc_lp_b, f->acc_lp_a, s->acc_lp_state, s->last_acc_lp);
    qrot(s->acc_quat, s->last_acc_lp, acc_earth);
    qnorm(acc_earth, 3);
    double q_w = std::sqrt(std::max((acc_earth[2]+1.0)/2.0, 0.0));
    double corr[4];
    if (q_w > 1e-6) { corr[0]=q_w; corr[1]=0.5*acc_earth[1]/q_w; corr[2]=-0.5*acc_earth[0]/q_w; corr[3]=0.0; }
    else { corr[0]=0.0; corr[1]=1.0; corr[2]=0.0; corr[3]=0.0; }
    double nq[4];
    quat_mul(corr, s->acc_quat, nq);
    std::memcpy(s->acc_quat, nq, sizeof(nq));
    qnorm(s->acc_quat, 4);

    if (p->motion_bias_est || p->rest_bias_est) {
        double bclip = p->bias_clip * D2R;
        double q6[4];
        quat_mul(s->acc_quat, s->gyr_quat, q6);
        double r[9] = {
            1-2*q6[2]*q6[2]-2*q6[3]*q6[3], 2*(q6[2]*q6[1]-q6[0]*q6[3]), 2*(q6[0]*q6[2]+q6[3]*q6[1]),
            2*(q6[0]*q6[3]+q6[2]*q6[1]), 1-2*q6[1]*q6[1]-2*q6[3]*q6[3], 2*(q6[2]*q6[3]-q6[1]*q6[0]),
            2*(q6[3]*q6[1]-q6[0]*q6[2]), 2*(q6[0]*q6[1]+q6[3]*q6[2]), 1-2*q6[1]*q6[1]-2*q6[2]*q6[2]};
        double bias_lp[2] = {
            r[0]*s->bias[0]+r[1]*s->bias[1]+r[2]*s->bias[2],
            r[3]*s->bias[0]+r[4]*s->bias[1]+r[5]*s->bias[2]};
        double r_in[9];
        std::memcpy(r_in, r, sizeof(r));
        fvec(r_in, 9, p->tau_acc, f->acc_ts, f->acc_lp_b, f->acc_lp_a, s->mb_r_lp_state, r);
        double b_in[2] = {bias_lp[0], bias_lp[1]};
        fvec(b_in, 2, p->tau_acc, f->acc_ts, f->acc_lp_b, f->acc_lp_a, s->mb_bias_lp_state, bias_lp);

        double w[3], e[3] = {0, 0, 0};
        if (s->rest_detected && p->rest_bias_est) {
            for (int i = 0; i < 3; i++) e[i] = s->rest_last_gyr_lp[i] - s->bias[i];
            double ident[9] = {1,0,0, 0,1,0, 0,0,1};
            std::memcpy(r, ident, sizeof(ident));
            w[0] = w[1] = w[2] = f->bias_rest_w;
        } else if (p->motion_bias_est) {
            e[0] = -acc_earth[1]/f->acc_ts + bias_lp[0] - r[0]*s->bias[0] - r[1]*s->bias[1] - r[2]*s->bias[2];
            e[1] = acc_earth[0]/f->acc_ts + bias_lp[1] - r[3]*s->bias[0] - r[4]*s->bias[1] - r[5]*s->bias[2];
            e[2] = -r[6]*s->bias[0] - r[7]*s->bias[1] - r[8]*s->bias[2];
            w[0] = w[1] = f->bias_motion_w;
            w[2] = f->bias_vertical_w;
        } else {
            w[0] = w[1] = w[2] = -1.0;
        }
        if (s->bias_p[0] < f->bias_p0) s->bias_p[0] += f->bias_v;
        if (s->bias_p[4] < f->bias_p0) s->bias_p[4] += f->bias_v;
        if (s->bias_p[8] < f->bias_p0) s->bias_p[8] += f->bias_v;
        if (w[0] >= 0.0) {
            for (int i = 0; i < 3; i++) e[i] = std::min(std::max(e[i], -bclip), bclip);
            double k[9];
            m3mul_t2(s->bias_p, r, k);
            m3mul(r, k, k);
            k[0] += w[0]; k[4] += w[1]; k[8] += w[2];
            m3inv(k, k);
            m3mul_t1(r, k, k);
            m3mul(s->bias_p, k, k);
            s->bias[0] += k[0]*e[0]+k[1]*e[1]+k[2]*e[2];
            s->bias[1] += k[3]*e[0]+k[4]*e[1]+k[5]*e[2];
            s->bias[2] += k[6]*e[0]+k[7]*e[1]+k[8]*e[2];
            m3mul(k, r, k);
            m3mul(k, s->bias_p, k);
            for (int i = 0; i < 9; i++) s->bias_p[i] -= k[i];
            for (int i = 0; i < 3; i++) s->bias[i] = std::min(std::max(s->bias[i], -bclip), bclip);
        }
    }
}

// offline VQF: gyr/acc (n,3) f64 -> quat6d (n,4). params packed as doubles:
// [tau_acc, bias_sigma_init, bias_forgetting_time, bias_clip, bias_sigma_motion,
//  bias_vertical_ff, bias_sigma_rest, rest_min_t, rest_filter_tau, rest_th_gyr,
//  rest_th_acc, motion_bias_est, rest_bias_est]
void vqf_offline(const double* gyr, const double* acc, int64_t n, double ts,
                 const double* pp, double* out_quat6d) {
    VQFP p;
    p.tau_acc = pp[0]; p.bias_sigma_init = pp[1]; p.bias_forgetting_time = pp[2];
    p.bias_clip = pp[3]; p.bias_sigma_motion = pp[4]; p.bias_vertical_forgetting_factor = pp[5];
    p.bias_sigma_rest = pp[6]; p.rest_min_t = pp[7]; p.rest_filter_tau = pp[8];
    p.rest_th_gyr = pp[9]; p.rest_th_acc = pp[10];
    p.motion_bias_est = pp[11] != 0.0; p.rest_bias_est = pp[12] != 0.0;

    VQFFilter* f = new VQFFilter();
    vqf_init(f, &p, ts);

    double* bias = new double[n*3];
    double* bias_p_inv1 = new double[n*9];

    for (int64_t i = 0; i < n; i++) {
        vqf_update(f, gyr + 3*i, acc + 3*i);
        std::memcpy(bias + 3*i, f->s.bias, 3*sizeof(double));
        m3inv(f->s.bias_p, bias_p_inv1 + 9*i);
    }
    vqf_reset(f);
    for (int64_t i = n-1; i >= 0; i--) {
        double tg[3] = {-gyr[3*i], -gyr[3*i+1], -gyr[3*i+2]};
        vqf_update(f, tg, acc + 3*i);
        double bpi2[9];
        m3inv(f->s.bias_p, bpi2);
        double b1[3] = {
            bias_p_inv1[9*i+0]*bias[3*i]+bias_p_inv1[9*i+1]*bias[3*i+1]+bias_p_inv1[9*i+2]*bias[3*i+2],
            bias_p_inv1[9*i+3]*bias[3*i]+bias_p_inv1[9*i+4]*bias[3*i+1]+bias_p_inv1[9*i+5]*bias[3*i+2],
            bias_p_inv1[9*i+6]*bias[3*i]+bias_p_inv1[9*i+7]*bias[3*i+1]+bias_p_inv1[9*i+8]*bias[3*i+2]};
        double b2[3] = {
            bpi2[0]*f->s.bias[0]+bpi2[1]*f->s.bias[1]+bpi2[2]*f->s.bias[2],
            bpi2[3]*f->s.bias[0]+bpi2[4]*f->s.bias[1]+bpi2[5]*f->s.bias[2],
            bpi2[6]*f->s.bias[0]+bpi2[7]*f->s.bias[1]+bpi2[8]*f->s.bias[2]};
        double diff[3] = {b1[0]-b2[0], b1[1]-b2[1], b1[2]-b2[2]};
        double psum[9];
        for (int j = 0; j < 9; j++) psum[j] = bias_p_inv1[9*i+j] + bpi2[j];
        double pinv[9];
        m3inv(psum, pinv);
        bias[3*i]   = pinv[0]*diff[0]+pinv[1]*diff[1]+pinv[2]*diff[2];
        bias[3*i+1] = pinv[3]*diff[0]+pinv[4]*diff[1]+pinv[5]*diff[2];
        bias[3*i+2] = pinv[6]*diff[0]+pinv[7]*diff[1]+pinv[8]*diff[2];
    }

    // gyro integration with blended bias
    double* quat3d = new double[n*4];
    double q[4] = {1, 0, 0, 0};
    for (int64_t i = 0; i < n; i++) {
        double g[3] = {gyr[3*i]-bias[3*i], gyr[3*i+1]-bias[3*i+1], gyr[3*i+2]-bias[3*i+2]};
        double gn = std::sqrt(g[0]*g[0]+g[1]*g[1]+g[2]*g[2]);
        if (gn > VEPS) {
            double angle = gn*ts;
            double c = std::cos(angle/2), sn = std::sin(angle/2)/gn;
            double dq[4] = {c, sn*g[0], sn*g[1], sn*g[2]};
            double nq[4];
            quat_mul(q, dq, nq);
            std::memcpy(q, nq, sizeof(nq));
            qnorm(q, 4);
        }
        std::memcpy(quat3d + 4*i, q, 4*sizeof(double));
    }

    // acc to inertial frame + zero-phase filter
    double* acc_i = new double[n*3];
    for (int64_t i = 0; i < n; i++) qrot(quat3d + 4*i, acc + 3*i, acc_i + 3*i);
    {
        double b[3], a[2], state[8];
        for (int i = 0; i < 8; i++) state[i] = NAN;
        fcoeffs(p.tau_acc, ts, b, a);
        double y[3];
        for (int64_t i = 0; i < n; i++) {
            fvec(acc_i + 3*i, 3, p.tau_acc, ts, b, a, state, y);
            std::memcpy(acc_i + 3*i, y, 3*sizeof(double));
        }
        for (int j = 0; j < 3; j++) finit(acc_i[3*(n-1)+j], b, a, state + 2*j);
        for (int64_t i = n-1; i >= 0; i--) {
            fvec(acc_i + 3*i, 3, p.tau_acc, ts, b, a, state, y);
            std::memcpy(acc_i + 3*i, y, 3*sizeof(double));
        }
    }

    // inclination correction
    double aq[4] = {1, 0, 0, 0};
    for (int64_t i = 0; i < n; i++) {
        double ae[3];
        qrot(aq, acc_i + 3*i, ae);
        qnorm(ae, 3);
        double q_w = std::sqrt(std::max((ae[2]+1.0)/2.0, 0.0));
        double corr[4];
        if (q_w > 1e-6) { corr[0]=q_w; corr[1]=0.5*ae[1]/q_w; corr[2]=-0.5*ae[0]/q_w; corr[3]=0.0; }
        else { corr[0]=0.0; corr[1]=1.0; corr[2]=0.0; corr[3]=0.0; }
        double nq[4];
        quat_mul(corr, aq, nq);
        std::memcpy(aq, nq, sizeof(nq));
        qnorm(aq, 4);
        quat_mul(aq, quat3d + 4*i, out_quat6d + 4*i);
    }

    delete[] bias;
    delete[] bias_p_inv1;
    delete[] quat3d;
    delete[] acc_i;
    delete f;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Lossless JPEG (ITU T.81 process 14, SOF3) decoder — the entropy codec of
// compressed CinemaDNG raws (DNG Compression=7). Serial Huffman decode is a
// genuine CPU hot loop (8+ MP/frame), hence native like the reference's
// decode path. Single scan, predictors 1-7, point transform, restart
// markers, up to 4 interleaved components.
// ---------------------------------------------------------------------------

namespace ljpeg {

struct BitReader {
    const uint8_t* d;
    int64_t n, pos;
    uint32_t acc;
    int bits;
    bool marker_hit;
    BitReader(const uint8_t* data, int64_t size)
        : d(data), n(size), pos(0), acc(0), bits(0), marker_hit(false) {}
    // next entropy byte with 0xFF00 unstuffing; stops at markers
    bool fill() {
        while (bits <= 24) {
            if (pos >= n) return bits > 0;
            uint8_t b = d[pos];
            if (b == 0xFF) {
                if (pos + 1 < n && d[pos + 1] == 0x00) { pos += 2; }
                else { marker_hit = true; return bits > 0; }
            } else {
                pos += 1;
            }
            acc = (acc << 8) | b;
            bits += 8;
        }
        return true;
    }
    int get_bit() {
        if (bits == 0 && !fill()) return -1;
        if (bits == 0) return -1;
        bits -= 1;
        return (acc >> bits) & 1;
    }
    int get_bits(int k) {
        int v = 0;
        for (int i = 0; i < k; i++) {
            int b = get_bit();
            if (b < 0) return -1;
            v = (v << 1) | b;
        }
        return v;
    }
    void reset_to_byte() { acc = 0; bits = 0; }
};

struct Huff {
    // canonical code decode via per-length min/max codes
    int32_t mincode[17], maxcode[17], valptr[17];
    uint8_t vals[256];
    bool ok = false;
    void build(const uint8_t counts[16], const uint8_t* symbols, int nsym) {
        int code = 0, k = 0;
        for (int l = 1; l <= 16; l++) {
            valptr[l] = k;
            mincode[l] = code;
            code += counts[l - 1];
            maxcode[l] = code - 1;
            if (counts[l - 1] == 0) maxcode[l] = -1;
            for (int i = 0; i < counts[l - 1] && k < nsym && k < 256; i++, k++)
                vals[k] = symbols[k];
            code <<= 1;
        }
        ok = true;
    }
    int decode(BitReader& br) const {
        int code = 0;
        for (int l = 1; l <= 16; l++) {
            int b = br.get_bit();
            if (b < 0) return -1;
            code = (code << 1) | b;
            if (maxcode[l] >= 0 && code <= maxcode[l])
                return vals[valptr[l] + code - mincode[l]];
        }
        return -1;
    }
};

static inline int extend(int v, int t) {
    if (t == 0) return 0;
    return (v < (1 << (t - 1))) ? v - ((1 << t) - 1) : v;
}

}  // namespace ljpeg

extern "C" {

// Returns 0 on success; negative on malformed input. out must hold
// lines*samples_per_line*ncomp uint16 values (query via the out_* fields by
// calling with out_cap=0 first: returns 1 and fills dimensions).
int ljpeg_decode(const uint8_t* data, int64_t size, uint16_t* out,
                 int64_t out_cap, int* out_w, int* out_h, int* out_ncomp) {
    using namespace ljpeg;
    if (size < 4 || data[0] != 0xFF || data[1] != 0xD8) return -1;
    int64_t p = 2;
    int precision = 0, height = 0, width = 0, ncomp = 0;
    int comp_tbl[4] = {0, 0, 0, 0};
    Huff tables[4];
    int predictor = 1, pt = 0, restart_interval = 0;
    int64_t scan_start = -1;

    while (p + 4 <= size) {
        if (data[p] != 0xFF) return -2;
        int m = data[p + 1];
        p += 2;
        if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7)) continue;
        if (m == 0xD9) break;
        if (p + 2 > size) return -3;
        int len = (data[p] << 8) | data[p + 1];
        if (p + len > size) return -4;
        const uint8_t* seg = data + p + 2;
        int seglen = len - 2;
        if (m == 0xC3) {                       // SOF3
            if (seglen < 6) return -5;
            precision = seg[0];
            height = (seg[1] << 8) | seg[2];
            width = (seg[3] << 8) | seg[4];
            ncomp = seg[5];
            if (ncomp < 1 || ncomp > 4 || seglen < 6 + 3 * ncomp) return -6;
            // per-component sampling must be 1x1 for lossless DNG
        } else if (m == 0xC4) {                // DHT
            int off = 0;
            while (off + 17 <= seglen) {
                int tc_th = seg[off];
                int th = tc_th & 0x0F;
                const uint8_t* counts = seg + off + 1;
                int nsym = 0;
                for (int i = 0; i < 16; i++) nsym += counts[i];
                if (off + 17 + nsym > seglen || th > 3 || nsym > 256)
                    return -7;
                tables[th].build(counts, seg + off + 17, nsym);
                off += 17 + nsym;
            }
        } else if (m == 0xDD) {                // DRI
            if (seglen >= 2) restart_interval = (seg[0] << 8) | seg[1];
        } else if (m == 0xDA) {                // SOS
            if (seglen < 1) return -8;
            int ns = seg[0];
            if (ns != ncomp || seglen < 1 + 2 * ns + 3) return -9;
            for (int i = 0; i < ns; i++) {
                comp_tbl[i] = (seg[1 + 2 * i + 1] >> 4) & 0x0F;
                if (comp_tbl[i] > 3) return -15;   // tables[4] bound
            }
            predictor = seg[1 + 2 * ns];       // Ss
            pt = seg[1 + 2 * ns + 2] & 0x0F;   // Al
            scan_start = p + len;
            break;
        }
        p += len;
    }
    if (scan_start < 0 || width <= 0 || height <= 0) return -10;
    *out_w = width;
    *out_h = height;
    *out_ncomp = ncomp;
    int64_t need = (int64_t)width * height * ncomp;
    if (out_cap < need) return 1;              // size query
    for (int c = 0; c < ncomp; c++)
        if (!tables[comp_tbl[c]].ok) return -11;
    if (predictor < 1 || predictor > 7) return -12;

    BitReader br(data + scan_start, size - scan_start);
    int default_pred = 1 << (precision - 1 - pt);
    int64_t row_vals = (int64_t)width * ncomp;
    int mcu_count = 0;
    for (int y = 0; y < height; y++) {
        uint16_t* row = out + (int64_t)y * row_vals;
        const uint16_t* prev = row - row_vals;
        for (int x = 0; x < width; x++) {
            if (restart_interval && mcu_count == restart_interval) {
                // re-sync: skip RSTn marker, restart prediction
                br.reset_to_byte();
                if (br.marker_hit && br.pos + 1 < br.n &&
                    br.d[br.pos] == 0xFF && br.d[br.pos + 1] >= 0xD0 &&
                    br.d[br.pos + 1] <= 0xD7) {
                    br.pos += 2;
                    br.marker_hit = false;
                }
                mcu_count = 0;
                // prediction restarts as at image start for this position
            }
            bool restart_here = (restart_interval && mcu_count == 0 &&
                                 (y > 0 || x > 0));
            for (int c = 0; c < ncomp; c++) {
                int t = tables[comp_tbl[c]].decode(br);
                if (t < 0) return -13;
                int diff;
                if (t == 16) diff = 32768;
                else {
                    int v = t ? br.get_bits(t) : 0;
                    if (v < 0) return -14;
                    diff = extend(v, t);
                }
                int pred;
                if ((y == 0 && x == 0) || restart_here) {
                    pred = default_pred;
                } else if (y == 0) {
                    pred = row[(int64_t)(x - 1) * ncomp + c];     // Ra
                } else if (x == 0) {
                    pred = prev[(int64_t)x * ncomp + c];          // Rb
                } else {
                    int ra = row[(int64_t)(x - 1) * ncomp + c];
                    int rb = prev[(int64_t)x * ncomp + c];
                    int rc = prev[(int64_t)(x - 1) * ncomp + c];
                    switch (predictor) {
                        case 1: pred = ra; break;
                        case 2: pred = rb; break;
                        case 3: pred = rc; break;
                        case 4: pred = ra + rb - rc; break;
                        case 5: pred = ra + ((rb - rc) >> 1); break;
                        case 6: pred = rb + ((ra - rc) >> 1); break;
                        default: pred = (ra + rb) >> 1; break;
                    }
                }
                row[(int64_t)x * ncomp + c] =
                    (uint16_t)((pred + diff) & 0xFFFF);
            }
            mcu_count++;
        }
    }
    if (pt) {
        // T.81 point transform (H.2.1): prediction ran in the shifted-down
        // domain; scale reconstructed samples back up by 2^Pt on output.
        int64_t total = (int64_t)height * row_vals;
        for (int64_t i = 0; i < total; i++)
            out[i] = (uint16_t)((out[i] << pt) & 0xFFFF);
    }
    return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Reference-CPU-path performance anchor (BASELINE.md "anchors to produce
// ourselves"). The reference's CPU fallback (cpu_undistort.rs:543-625) does,
// per output pixel: a rolling-shutter center-matrix probe + row-matrix
// projection (two 3x3 homogeneous transforms), the forward fisheye distort
// (atan + 8th-order polynomial), and an interpolated gather (lanczos4: 8x8
// LUT taps), rayon-parallel over rows. Rust/cargo is not available in this
// image, so this is a native C++ re-statement of the SAME per-pixel work
// (math mirrored from our independent oracle, tests/oracle.py — not copied
// from the reference) used purely to measure what that algorithm achieves on
// host CPU cores. Not part of the stabilization pipeline.
// ---------------------------------------------------------------------------

#include <atomic>
#include <thread>
#include <vector>

namespace anchor {

static const int TAB = 32;          // 32-phase fixed-point LUT, 8 taps
static float g_lut[TAB + 1][8];
static bool g_lut_init = false;

static void init_lut() {
    if (g_lut_init) return;
    const double a = 4.0;           // lanczos4
    for (int p = 0; p <= TAB; p++) {
        double fr = (double)p / TAB;
        double sum = 0.0;
        for (int t = 0; t < 8; t++) {
            double x = (double)(t - 3) - fr;
            double w;
            if (std::fabs(x) < 1e-12) w = 1.0;
            else if (std::fabs(x) >= a) w = 0.0;
            else {
                double px = M_PI * x;
                w = a * std::sin(px) * std::sin(px / a) / (px * px);
            }
            g_lut[p][t] = (float)w;
            sum += w;
        }
        for (int t = 0; t < 8; t++) g_lut[p][t] = (float)(g_lut[p][t] / sum);
    }
    g_lut_init = true;
}

struct Params {
    float f0, f1, c0, c1;
    float k1, k2, k3, k4;
    float r_limit, bg;
};

// Forward fisheye projection of one output position through matrix row m
// (14 floats; cols 0-8 are the 3x3). Returns false when behind the camera
// or past the radial limit.
static inline bool rot_and_distort(const float* m, float x, float y,
                                   const Params& pr, float* u, float* v) {
    float _x = m[0] * x + m[1] * y + m[2];
    float _y = m[3] * x + m[4] * y + m[5];
    float _w = m[6] * x + m[7] * y + m[8];
    if (_w <= 0.0f) return false;
    float px = _x / _w, py = _y / _w;
    float r2 = px * px + py * py;
    if (pr.r_limit > 0.0f && r2 > pr.r_limit * pr.r_limit) return false;
    float r = std::sqrt(r2);
    float scale = 1.0f;
    if (r > 1e-8f) {
        float th = std::atan(r);
        float t2 = th * th;
        float thd = th * (1.0f + t2 * (pr.k1 + t2 * (pr.k2 + t2 * (pr.k3 + t2 * pr.k4))));
        scale = thd / r;
    }
    *u = pr.f0 * px * scale + pr.c0;
    *v = pr.f1 * py * scale + pr.c1;
    return true;
}

static void rows_worker(const float* img, int h, int w, const float* mats,
                        int nmat, const Params pr, float* out, int oh, int ow,
                        std::atomic<int>* next_row) {
    const float* mc = mats + (int64_t)(nmat / 2) * 14;   // center probe matrix
    for (;;) {
        int y = next_row->fetch_add(1);
        if (y >= oh) return;
        float* orow = out + (int64_t)y * ow;
        for (int x = 0; x < ow; x++) {
            float fx = (float)x, fy = (float)y;
            float u, v;
            // RS row select: center-matrix probe picks the source row, whose
            // matrix then projects for real (cpu_undistort.rs:465-482 shape)
            int idx = y;
            if (nmat > 1 && rot_and_distort(mc, fx, fy, pr, &u, &v))
                idx = (int)v;
            if (idx < 0) idx = 0;
            if (idx >= nmat) idx = nmat - 1;
            if (!rot_and_distort(mats + (int64_t)idx * 14, fx, fy, pr, &u, &v)) {
                orow[x] = pr.bg;
                continue;
            }
            // fixed-point 5-bit phase, separable 8x8 lanczos4 LUT taps
            int su = (int)std::lround(u * TAB);
            int sv = (int)std::lround(v * TAB);
            int bx = (su >> 5) - 3, by = (sv >> 5) - 3;
            const float* wx = g_lut[su & (TAB - 1)];
            const float* wy = g_lut[sv & (TAB - 1)];
            float acc = 0.0f;
            for (int ty = 0; ty < 8; ty++) {
                int yy = by + ty;
                if (yy < 0) yy = 0;
                if (yy >= h) yy = h - 1;
                const float* irow = img + (int64_t)yy * w;
                float racc = 0.0f;
                for (int tx = 0; tx < 8; tx++) {
                    int xx = bx + tx;
                    if (xx < 0) xx = 0;
                    if (xx >= w) xx = w - 1;
                    racc += wx[tx] * irow[xx];
                }
                acc += wy[ty] * racc;
            }
            orow[x] = acc;
        }
    }
}

}  // namespace anchor

extern "C" {

// Single-plane remap with the reference-CPU-path per-pixel workload.
// img: (h, w) f32; mats: (nmat, 14) f32; params: [f0 f1 c0 c1 k1 k2 k3 k4
// r_limit bg]; out: (oh, ow) f32. nthreads <= 0 => hardware concurrency.
void ref_cpu_remap_anchor(const float* img, int h, int w, const float* mats,
                          int nmat, const float* params, float* out, int oh,
                          int ow, int nthreads) {
    anchor::init_lut();
    anchor::Params pr{params[0], params[1], params[2], params[3], params[4],
                      params[5], params[6], params[7], params[8], params[9]};
    if (nthreads <= 0)
        nthreads = (int)std::thread::hardware_concurrency();
    if (nthreads < 1) nthreads = 1;
    std::atomic<int> next_row{0};
    if (nthreads == 1) {
        anchor::rows_worker(img, h, w, mats, nmat, pr, out, oh, ow, &next_row);
        return;
    }
    std::vector<std::thread> ts;
    for (int i = 0; i < nthreads; i++)
        ts.emplace_back(anchor::rows_worker, img, h, w, mats, nmat, pr, out,
                        oh, ow, &next_row);
    for (auto& t : ts) t.join();
}

}  // extern "C"
