/* so_native — C runtime components for so_tpu_torch (a copy of
 * so_tpu/native/so_native.c; the port builds its own library from it).
 *
 * The TPU solves R_Delta in bulk; two host-side pieces remain serial or
 * I/O-bound at 1e6-halo scale and live here as native code:
 *
 *   1. so_conflict_pass: the mass-ordered subsume/slurp/retain protocol
 *      (reference semantics: kdTagParticles kd2.c:663-720, kdZeroGroup
 *      kd2.c:617-643, driven by kdSO kd2.c:864-895). Order-dependent and
 *      inherently sequential across halos; O(total interior particles)
 *      here vs the reference's O(groups) kdFindGroup scan per owned
 *      particle and O(N) kdZeroGroup sweep per subsume event.
 *
 *   2. so_write_int_array: tipsy-array ASCII writing ("%d\n" per particle,
 *      kdWriteArray kd2.c:1244-1264) without Python string overhead.
 *
 * Built as a plain shared library; Python binds via ctypes
 * (so_tpu_torch/native/__init__.py) with a pure-numpy fallback.
 */

#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

/* Mass-ordered conflict protocol over CSR member lists.
 *
 * Inputs:
 *   n_groups, index[g] (1-based catalog ids), pos[3g] (post-recentre),
 *   mvir[g]/rvir[g] (solver output; error codes <= 0 included),
 *   code[g] (0 ok, negative error), order[n_groups] (processing order,
 *   ascending GTP mass via indexx), members CSR (mem_off[g]..mem_off[g+1]
 *   int64 rows into the particle arrays, ascending distance),
 *   n_particles.
 * Outputs (caller-allocated):
 *   igrp[n_particles] (zeroed), n_sub[n_particles] (zeroed),
 *   n_ign[n_particles] (zeroed), mvir/rvir mutated in place,
 *   slurped_own[n_groups] (zeroed), counters[2] = {removed, slurped}.
 *
 * id2row: caller passes max_index+1 int64 slots mapping catalog id -> row.
 * owner_first/owner_cls are scratch (n_groups ints each), epoch-stamped so
 * no per-halo clearing is needed.
 * Returns 0 on success, negative on internal inconsistency.
 */
int so_conflict_pass(
    int64_t n_groups, const int32_t *restrict index,
    const float *restrict pos, float *restrict mvir, float *restrict rvir,
    const int32_t *restrict code, const int64_t *restrict order,
    const int64_t *restrict mem_off, const int64_t *restrict mem,
    int64_t n_particles, const int64_t *restrict id2row, int64_t max_id,
    int32_t *restrict igrp, int32_t *restrict n_sub, int32_t *restrict n_ign,
    uint8_t *restrict slurped_own, int64_t *restrict counters)
{
    /* per-particle reverse membership for kdZeroGroup-equivalent sweeps:
     * for each group, the list of particles currently tagged to it. We
     * track tags with a per-group dynamic array. */
    int64_t *grp_tag_count = calloc(n_groups, sizeof(int64_t));
    int64_t *grp_tag_cap = calloc(n_groups, sizeof(int64_t));
    int64_t **grp_tags = calloc(n_groups, sizeof(int64_t *));
    int32_t *owner_epoch = calloc(n_groups, sizeof(int32_t));
    int32_t *owner_cls = calloc(n_groups, sizeof(int32_t));
    if (!grp_tag_count || !grp_tag_cap || !grp_tags || !owner_epoch || !owner_cls) {
        free(grp_tag_count); free(grp_tag_cap); free(grp_tags);
        free(owner_epoch); free(owner_cls);
        return -1;
    }
    int64_t removed = 0, slurped = 0;
    int rc = 0;

    for (int64_t oi = 0; oi < n_groups && rc == 0; ++oi) {
        int64_t a = order[oi];
        if (code[a] != 0) continue;
        int64_t lo = mem_off[a], hi = mem_off[a + 1];
        if (hi <= lo) continue;
        int32_t a_id = index[a];
        float rva2 = rvir[a] * rvir[a];
        int32_t epoch = (int32_t)oi + 1;

        /* ensure tag array capacity for A (it can gain up to hi-lo tags,
         * plus later groups may re-tag; grow geometrically) */
        int64_t k_s = -1, slurper = -1;

        for (int64_t k = lo; k < hi; ++k) {
            /* rows are distance-sorted, i.e. random in memory: the scan is
             * DRAM-latency bound, so keep a window of loads in flight */
            if (k + 16 < hi) __builtin_prefetch(&igrp[mem[k + 16]], 0, 0);
            int32_t own = igrp[mem[k]];
            if (own == 0) continue;
            if (own < 0 || own > max_id || id2row[own] < 0) { rc = -2; break; }
            int64_t b = id2row[own];
            if (owner_epoch[b] != epoch) {
                float dx = pos[3 * a] - pos[3 * b];
                float dy = pos[3 * a + 1] - pos[3 * b + 1];
                float dz = pos[3 * a + 2] - pos[3 * b + 2];
                float r2 = dx * dx + dy * dy + dz * dz;   /* raw, no wrap (kd2.c:677-680) */
                owner_epoch[b] = epoch;
                if (r2 <= rva2) owner_cls[b] = 2;                     /* subsume */
                else if (r2 <= rvir[b] * rvir[b]) owner_cls[b] = 1;   /* slurp  */
                else owner_cls[b] = 0;                                /* retain */
            }
            if (owner_cls[b] == 1) { k_s = k; slurper = b; break; }
        }
        if (rc != 0) break;
        int64_t pref_end = (k_s >= 0) ? k_s : hi;

        /* walk the prefix: subsume events, retain counters, A-tags */
        for (int64_t k = lo; k < pref_end; ++k) {
            if (k + 16 < pref_end)
                __builtin_prefetch(&igrp[mem[k + 16]], 1, 0);
            int64_t p = mem[k];
            int32_t own = igrp[p];
            if (own != 0) {
                int64_t b = id2row[own];
                if (owner_cls[b] == 2 && owner_epoch[b] == epoch) {
                    /* kdZeroGroup(B): every particle tagged B gets
                     * nSubsumed++ and iGrp=0 (kd2.c:636-641) */
                    if (mvir[b] < 0.0f) { rc = -3; break; }
                    for (int64_t t = 0; t < grp_tag_count[b]; ++t) {
                        int64_t q = grp_tags[b][t];
                        if (igrp[q] == own) { n_sub[q]++; igrp[q] = 0; }
                    }
                    grp_tag_count[b] = 0;
                    rvir[b] = -10.0f * (float)a_id;
                    mvir[b] = -mvir[b];
                    removed++;
                    /* mark consumed so a second B particle doesn't re-fire */
                    owner_cls[b] = 3;
                    own = 0;  /* p was just zeroed; falls through to tag-A */
                } else if (owner_cls[b] == 3 && owner_epoch[b] == epoch) {
                    own = igrp[p];  /* already zeroed by the sweep */
                } else {
                    /* retain: B keeps it, nIgnored++ (kd2.c:706-715) */
                    n_ign[p]++;
                    continue;
                }
            }
            if (igrp[p] == 0) {
                igrp[p] = a_id;
                if (grp_tag_count[a] == grp_tag_cap[a]) {
                    int64_t nc = grp_tag_cap[a] ? grp_tag_cap[a] * 2 : 64;
                    int64_t *na = realloc(grp_tags[a], nc * sizeof(int64_t));
                    if (!na) { rc = -1; break; }
                    grp_tags[a] = na; grp_tag_cap[a] = nc;
                }
                grp_tags[a][grp_tag_count[a]++] = p;
            }
        }
        if (rc != 0) break;

        if (k_s >= 0) {
            /* slurp: zero everything currently tagged A (kd2.c:694-705) */
            if (mvir[a] < 0.0f) { rc = -3; break; }
            for (int64_t t = 0; t < grp_tag_count[a]; ++t) {
                int64_t q = grp_tags[a][t];
                if (igrp[q] == a_id) { n_sub[q]++; igrp[q] = 0; }
            }
            grp_tag_count[a] = 0;
            rvir[a] = -10.0f * (float)index[slurper];
            mvir[a] = -mvir[a];
            slurped_own[a] = 1;
            slurped++;
        }
    }

    counters[0] = removed;
    counters[1] = slurped;
    for (int64_t g = 0; g < n_groups; ++g) free(grp_tags[g]);
    free(grp_tags); free(grp_tag_count); free(grp_tag_cap);
    free(owner_epoch); free(owner_cls);
    return rc;
}

/* Segment variant for multi-controller runs: append n "%d\n" lines at a
 * byte offset of an EXISTING file (process 0 pre-creates it with the
 * count header and truncates to the exact total size; each host then
 * writes only its own particle segment — the .sogrp ownership story for
 * 1e9-particle runs). No header is written here. */
int so_write_int_array_segment(const char *path, const int32_t *vals,
                               int64_t n, int64_t offset)
{
    FILE *fp = fopen(path, "r+b");
    if (!fp) return -1;
    if (fseeko(fp, (off_t)offset, SEEK_SET)) { fclose(fp); return -5; }
    enum { CAP = 1 << 20 };
    char *buf = malloc(CAP);
    if (!buf) { fclose(fp); return -2; }
    char *p = buf;
    for (int64_t i = 0; i < n; ++i) {
        if (p - buf > CAP - 16) {
            if (fwrite(buf, 1, (size_t)(p - buf), fp) != (size_t)(p - buf)) {
                free(buf); fclose(fp); return -3;
            }
            p = buf;
        }
        int64_t v = vals[i];
        uint64_t u = v < 0 ? (*p++ = '-', (uint64_t)(-v)) : (uint64_t)v;
        char tmp[12];
        int k = 0;
        do { tmp[k++] = (char)('0' + (u % 10)); u /= 10; } while (u);
        while (k) *p++ = tmp[--k];
        *p++ = '\n';
    }
    int rc = 0;
    if (p != buf && fwrite(buf, 1, (size_t)(p - buf), fp) != (size_t)(p - buf))
        rc = -3;
    free(buf);
    return fclose(fp) ? -4 : rc;
}

/* Fast "%d\n" array writer (kdWriteArray format, kd2.c:1244-1264). */
int so_write_int_array(const char *path, const int32_t *vals, int64_t n)
{
    /* manual integer formatting: ~5x fprintf("%d\n") — a 1024^3 .sogrp
     * is a billion lines, where the formatter IS the write time */
    FILE *fp = fopen(path, "w");
    if (!fp) return -1;
    enum { CAP = 1 << 20 };
    char *buf = malloc(CAP);
    if (!buf) { fclose(fp); return -2; }
    char *p = buf;
    p += sprintf(p, "%lld\n", (long long)n);
    for (int64_t i = 0; i < n; ++i) {
        if (p - buf > CAP - 16) {
            if (fwrite(buf, 1, (size_t)(p - buf), fp) != (size_t)(p - buf)) {
                free(buf); fclose(fp); return -3;
            }
            p = buf;
        }
        int64_t v = vals[i];
        uint64_t u = v < 0 ? (*p++ = '-', (uint64_t)(-v)) : (uint64_t)v;
        char tmp[12];
        int k = 0;
        do { tmp[k++] = (char)('0' + (u % 10)); u /= 10; } while (u);
        while (k) *p++ = tmp[--k];
        *p++ = '\n';
    }
    int rc = 0;
    if (p != buf && fwrite(buf, 1, (size_t)(p - buf), fp) != (size_t)(p - buf))
        rc = -3;
    free(buf);
    return fclose(fp) ? -4 : rc;
}

/* One-pass run statistics (kdOutStats reductions, kd2.c:1334-1415):
 * the per-particle sub/ign/tag sums fused into a single sweep with
 * sequential f64 accumulation — the reference's own association — vs
 * ~10 separate numpy passes that dominate the post-solve wall on
 * memory-bandwidth-poor hosts at 10^7+ particles.
 * fout: [cum_mass_sub, mass_sub, cum_mass_ign, mass_ign, particle_mass]
 * iout: [cum_sub, n_sub_particles, cum_ign, n_ign_particles]          */
int so_stats_pass(int64_t n, const float *mass, const int32_t *igrp,
                  const int32_t *nsub, const int32_t *nign,
                  double *fout, int64_t *iout)
{
    double cms = 0.0, ms = 0.0, cmi = 0.0, mi = 0.0, pm = 0.0;
    int64_t cs = 0, ps = 0, ci = 0, pi = 0;
    for (int64_t i = 0; i < n; ++i) {
        double m = (double)mass[i];
        int32_t s = nsub[i], g = nign[i];
        if (s) { cs += s; ps++; cms += m * (double)s; ms += m; }
        if (g) { ci += g; pi++; cmi += m * (double)g; mi += m; }
        if (igrp[i] > 0) pm += m;
    }
    fout[0] = cms; fout[1] = ms; fout[2] = cmi; fout[3] = mi; fout[4] = pm;
    iout[0] = cs; iout[1] = ps; iout[2] = ci; iout[3] = pi;
    return 0;
}

/* NR indexx (nr.c:91-151): index quicksort with insertion-sort leaves and
 * median-of-three pivoting. The halo processing order is bit-defined by
 * this exact algorithm's TIE behavior (kdSortMass, kd2.c:843-861), so this
 * is a faithful transliteration of numerics._indexx_nr (itself the NR
 * port) — the pure-Python form costs ~100 ms at 16k keys / ~10 s at 1e6
 * whenever float32 masses collide (birthday ties are routine in large
 * catalogs).
 * arr1: 1-based keys (arr1[0] unused); indx: n+1 slots, 1-based result.
 * Returns 0 on success, -1 if the NR stack overflows. */
int so_indexx(int64_t n, const double *restrict arr1, int64_t *restrict indx)
{
    enum { NR_M = 7, NSTACK = 50 };
    int64_t istack[NSTACK + 1];
    int64_t jstack = 0, l = 1, ir = n;
    for (int64_t j = 0; j <= n; ++j) indx[j] = j;
    for (;;) {
        if (ir - l < NR_M) {
            for (int64_t j = l + 1; j <= ir; ++j) {
                int64_t indxt = indx[j];
                double a = arr1[indxt];
                int64_t i = j - 1;
                while (i >= 1) {
                    if (arr1[indx[i]] <= a) break;
                    indx[i + 1] = indx[i];
                    i--;
                }
                indx[i + 1] = indxt;
            }
            if (jstack == 0) break;
            ir = istack[jstack--];
            l = istack[jstack--];
        } else {
            int64_t k = (l + ir) >> 1;
            int64_t t = indx[k]; indx[k] = indx[l + 1]; indx[l + 1] = t;
            if (arr1[indx[l + 1]] > arr1[indx[ir]]) {
                t = indx[l + 1]; indx[l + 1] = indx[ir]; indx[ir] = t;
            }
            if (arr1[indx[l]] > arr1[indx[ir]]) {
                t = indx[l]; indx[l] = indx[ir]; indx[ir] = t;
            }
            if (arr1[indx[l + 1]] > arr1[indx[l]]) {
                t = indx[l + 1]; indx[l + 1] = indx[l]; indx[l] = t;
            }
            int64_t i = l + 1, j = ir;
            int64_t indxt = indx[l];
            double a = arr1[indxt];
            for (;;) {
                do { i++; } while (arr1[indx[i]] < a);
                do { j--; } while (arr1[indx[j]] > a);
                if (j < i) break;
                t = indx[i]; indx[i] = indx[j]; indx[j] = t;
            }
            indx[l] = indx[j];
            indx[j] = indxt;
            jstack += 2;
            if (jstack > NSTACK) return -1;
            if (ir - i + 1 >= j - l) {
                istack[jstack] = ir;
                istack[jstack - 1] = i;
                ir = j - 1;
            } else {
                istack[jstack] = j - 1;
                istack[jstack - 1] = l;
                l = i;
            }
        }
    }
    return 0;
}
