// tm_native — host-side native kernels for torchmetrics_tpu.
//
// TPU-native replacement for the reference's third-party native backends
// (SURVEY.md §2.9): pycocotools' C RLE codec/IoU (reference
// detection/mean_ap.py:50-71), scipy's linear_sum_assignment used by PIT
// (reference functional/audio/pit.py:42-62), and the pure-Python Levenshtein
// DP (reference functional/text/helper.py). Device math stays in JAX; these
// are the string/assignment/RLE host paths that never touch the TPU.
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this image).
#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>
#include <limits>
#include <cmath>

extern "C" {

// ---------------------------------------------------------------------------
// Levenshtein
// ---------------------------------------------------------------------------

// Unit-cost edit distance between int64 token sequences.
int64_t tm_edit_distance(const int64_t* a, int64_t la, const int64_t* b, int64_t lb) {
    if (la == 0) return lb;
    if (lb == 0) return la;
    std::vector<int64_t> prev(lb + 1), cur(lb + 1);
    for (int64_t j = 0; j <= lb; ++j) prev[j] = j;
    for (int64_t i = 1; i <= la; ++i) {
        cur[0] = i;
        const int64_t ai = a[i - 1];
        for (int64_t j = 1; j <= lb; ++j) {
            const int64_t sub = prev[j - 1] + (ai != b[j - 1]);
            const int64_t del = prev[j] + 1;
            const int64_t ins = cur[j - 1] + 1;
            cur[j] = std::min(sub, std::min(del, ins));
        }
        std::swap(prev, cur);
    }
    return prev[lb];
}

// Edit distance decomposed into (substitutions, deletions, insertions, hits)
// via full DP + backtrace, pred->tgt edits. out must hold 4 int64.
void tm_edit_distance_counts(const int64_t* pred, int64_t m, const int64_t* tgt, int64_t n,
                             int64_t* out) {
    std::vector<int32_t> dp((m + 1) * (n + 1));
    const int64_t W = n + 1;
    for (int64_t i = 0; i <= m; ++i) dp[i * W] = (int32_t)i;
    for (int64_t j = 0; j <= n; ++j) dp[j] = (int32_t)j;
    for (int64_t i = 1; i <= m; ++i) {
        const int64_t pi = pred[i - 1];
        for (int64_t j = 1; j <= n; ++j) {
            const int32_t sub = dp[(i - 1) * W + (j - 1)] + (pi != tgt[j - 1]);
            const int32_t del = dp[(i - 1) * W + j] + 1;
            const int32_t ins = dp[i * W + (j - 1)] + 1;
            dp[i * W + j] = std::min(sub, std::min(del, ins));
        }
    }
    int64_t s = 0, d = 0, ins_c = 0, hits = 0;
    int64_t i = m, j = n;
    while (i > 0 || j > 0) {
        if (i > 0 && j > 0 &&
            dp[i * W + j] == dp[(i - 1) * W + (j - 1)] + (pred[i - 1] != tgt[j - 1])) {
            if (pred[i - 1] == tgt[j - 1]) ++hits; else ++s;
            --i; --j;
        } else if (i > 0 && dp[i * W + j] == dp[(i - 1) * W + j] + 1) {
            ++d; --i;
        } else {
            ++ins_c; --j;
        }
    }
    out[0] = s; out[1] = d; out[2] = ins_c; out[3] = hits;
}

// Batched edit distance over packed sequences: offsets are prefix sums
// (len B+1); out[b] = distance(pred_b, tgt_b).
void tm_edit_distance_batch(const int64_t* preds, const int64_t* pred_off,
                            const int64_t* tgts, const int64_t* tgt_off,
                            int64_t batch, int64_t* out) {
    for (int64_t b = 0; b < batch; ++b) {
        out[b] = tm_edit_distance(preds + pred_off[b], pred_off[b + 1] - pred_off[b],
                                  tgts + tgt_off[b], tgt_off[b + 1] - tgt_off[b]);
    }
}

// Batched counts variant: out is (batch, 4) row-major [S, D, I, H].
void tm_edit_distance_counts_batch(const int64_t* preds, const int64_t* pred_off,
                                   const int64_t* tgts, const int64_t* tgt_off,
                                   int64_t batch, int64_t* out) {
    for (int64_t b = 0; b < batch; ++b) {
        tm_edit_distance_counts(preds + pred_off[b], pred_off[b + 1] - pred_off[b],
                                tgts + tgt_off[b], tgt_off[b + 1] - tgt_off[b],
                                out + 4 * b);
    }
}

// ---------------------------------------------------------------------------
// Linear sum assignment (Jonker-Volgenant shortest augmenting path, O(n^3)).
// cost is row-major (n rows, m cols), n <= m required. Writes col4row[n].
// Minimizes total cost. Returns 0 on success, -1 on invalid input.
// ---------------------------------------------------------------------------
int tm_linear_sum_assignment(const double* cost, int64_t n, int64_t m, int64_t* col4row) {
    if (n <= 0 || m <= 0 || n > m) return -1;
    const double INF = std::numeric_limits<double>::infinity();
    std::vector<double> u(n, 0.0), v(m, 0.0), shortest(m);
    std::vector<int64_t> row4col(m, -1), path(m, -1);
    std::vector<char> SR(n), SC(m);
    std::vector<int64_t> remaining(m);
    std::fill(col4row, col4row + n, -1);

    for (int64_t curRow = 0; curRow < n; ++curRow) {
        double minVal = 0.0;
        int64_t i = curRow, sink = -1;
        std::fill(SR.begin(), SR.end(), 0);
        std::fill(SC.begin(), SC.end(), 0);
        std::fill(shortest.begin(), shortest.end(), INF);
        int64_t numRemaining = m;
        for (int64_t it = 0; it < m; ++it) remaining[it] = m - it - 1;

        while (sink == -1) {
            int64_t index = -1;
            double lowest = INF;
            SR[i] = 1;
            for (int64_t it = 0; it < numRemaining; ++it) {
                const int64_t j = remaining[it];
                const double r = minVal + cost[i * m + j] - u[i] - v[j];
                if (r < shortest[j]) { path[j] = i; shortest[j] = r; }
                if (shortest[j] < lowest || (shortest[j] == lowest && row4col[j] == -1)) {
                    lowest = shortest[j]; index = it;
                }
            }
            minVal = lowest;
            if (minVal == INF) return -1;  // infeasible
            const int64_t j = remaining[index];
            if (row4col[j] == -1) sink = j; else i = row4col[j];
            SC[j] = 1;
            remaining[index] = remaining[--numRemaining];
        }
        u[curRow] += minVal;
        for (int64_t ii = 0; ii < n; ++ii)
            if (SR[ii] && ii != curRow) u[ii] += minVal - shortest[col4row[ii]];
        for (int64_t jj = 0; jj < m; ++jj)
            if (SC[jj]) v[jj] -= minVal - shortest[jj];
        // augment
        int64_t j = sink;
        while (true) {
            const int64_t ii = path[j];
            row4col[j] = ii;
            std::swap(col4row[ii], j);
            if (ii == curRow) break;
        }
    }
    return 0;
}

// ---------------------------------------------------------------------------
// COCO-compatible RLE (column-major run-length encoding of binary masks).
// counts alternate runs of 0s and 1s, starting with 0s, scanning columns
// first (Fortran order) — byte-compatible with pycocotools' semantics.
// ---------------------------------------------------------------------------

// Encode dense row-major (h, w) uint8 mask. out_counts must hold h*w+1.
// Returns number of runs written.
int64_t tm_rle_encode(const uint8_t* mask, int64_t h, int64_t w, uint32_t* out_counts) {
    int64_t nruns = 0;
    uint8_t prev = 0;
    uint32_t run = 0;
    for (int64_t c = 0; c < w; ++c) {
        for (int64_t r = 0; r < h; ++r) {
            const uint8_t val = mask[r * w + c] ? 1 : 0;
            if (val == prev) { ++run; }
            else { out_counts[nruns++] = run; run = 1; prev = val; }
        }
    }
    out_counts[nruns++] = run;
    return nruns;
}

// Decode RLE into dense row-major (h, w) uint8 mask.
void tm_rle_decode(const uint32_t* counts, int64_t ncounts, int64_t h, int64_t w,
                   uint8_t* out_mask) {
    int64_t pos = 0;  // column-major linear index
    uint8_t val = 0;
    for (int64_t k = 0; k < ncounts; ++k) {
        for (uint32_t t = 0; t < counts[k]; ++t) {
            const int64_t c = pos / h, r = pos % h;
            out_mask[r * w + c] = val;
            ++pos;
        }
        val = 1 - val;
    }
}

uint64_t tm_rle_area(const uint32_t* counts, int64_t ncounts) {
    uint64_t area = 0;
    for (int64_t k = 1; k < ncounts; k += 2) area += counts[k];
    return area;
}

// Intersection of two RLEs (same h*w extent) without decoding.
static uint64_t rle_intersection(const uint32_t* a, int64_t na, const uint32_t* b, int64_t nb) {
    uint64_t inter = 0;
    int64_t ka = 0, kb = 0;
    uint64_t ca = na ? a[0] : 0, cb = nb ? b[0] : 0;  // remaining in current run
    uint8_t va = 0, vb = 0;
    while (ka < na && kb < nb) {
        const uint64_t step = std::min(ca, cb);
        if (va && vb) inter += step;
        ca -= step; cb -= step;
        if (ca == 0) { ++ka; va = 1 - va; if (ka < na) ca = a[ka]; }
        if (cb == 0) { ++kb; vb = 1 - vb; if (kb < nb) cb = b[kb]; }
    }
    return inter;
}

// Pairwise IoU between n_dt and n_gt RLE masks, flattened counts arrays with
// prefix offsets (len n+1). iscrowd is per-gt; crowd IoU = inter/area_dt.
// out is row-major (n_dt, n_gt) double.
void tm_rle_iou(const uint32_t* dt_counts, const int64_t* dt_off, int64_t n_dt,
                const uint32_t* gt_counts, const int64_t* gt_off, int64_t n_gt,
                const uint8_t* iscrowd, double* out) {
    std::vector<uint64_t> dt_area(n_dt), gt_area(n_gt);
    for (int64_t i = 0; i < n_dt; ++i)
        dt_area[i] = tm_rle_area(dt_counts + dt_off[i], dt_off[i + 1] - dt_off[i]);
    for (int64_t j = 0; j < n_gt; ++j)
        gt_area[j] = tm_rle_area(gt_counts + gt_off[j], gt_off[j + 1] - gt_off[j]);
    for (int64_t i = 0; i < n_dt; ++i) {
        for (int64_t j = 0; j < n_gt; ++j) {
            const uint64_t inter = rle_intersection(
                dt_counts + dt_off[i], dt_off[i + 1] - dt_off[i],
                gt_counts + gt_off[j], gt_off[j + 1] - gt_off[j]);
            double denom;
            if (iscrowd && iscrowd[j]) denom = (double)dt_area[i];
            else denom = (double)dt_area[i] + (double)gt_area[j] - (double)inter;
            out[i * n_gt + j] = denom > 0 ? (double)inter / denom : 0.0;
        }
    }
}

// Pairwise box IoU (xyxy), crowd semantics as above. out (n_dt, n_gt).
void tm_box_iou(const double* dt, int64_t n_dt, const double* gt, int64_t n_gt,
                const uint8_t* iscrowd, double* out) {
    for (int64_t i = 0; i < n_dt; ++i) {
        const double ax0 = dt[i * 4], ay0 = dt[i * 4 + 1], ax1 = dt[i * 4 + 2], ay1 = dt[i * 4 + 3];
        const double a_area = std::max(0.0, ax1 - ax0) * std::max(0.0, ay1 - ay0);
        for (int64_t j = 0; j < n_gt; ++j) {
            const double bx0 = gt[j * 4], by0 = gt[j * 4 + 1], bx1 = gt[j * 4 + 2], by1 = gt[j * 4 + 3];
            const double b_area = std::max(0.0, bx1 - bx0) * std::max(0.0, by1 - by0);
            const double iw = std::min(ax1, bx1) - std::max(ax0, bx0);
            const double ih = std::min(ay1, by1) - std::max(ay0, by0);
            const double inter = (iw > 0 && ih > 0) ? iw * ih : 0.0;
            const double denom = (iscrowd && iscrowd[j]) ? a_area : a_area + b_area - inter;
            out[i * n_gt + j] = denom > 0 ? inter / denom : 0.0;
        }
    }
}

// Batched pairwise box IoU over N independent (dt set, gt set) cells with
// flat concatenated storage — one ctypes round-trip for a whole epoch of
// per-(image, class) IoU matrices (the per-call marshalling otherwise
// dominates: ~13us x thousands of calls).
// dt_flat: sum(n_dt) boxes; offsets are element counts (not byte offsets);
// out_flat laid out cell-major with out_off[c] = sum of n_dt*n_gt before c.
void tm_box_iou_batch(const double* dt_flat, const int64_t* dt_off,
                      const double* gt_flat, const int64_t* gt_off,
                      const uint8_t* crowd_flat, int64_t n_cells,
                      double* out_flat, const int64_t* out_off) {
    for (int64_t c = 0; c < n_cells; ++c) {
        const int64_t n_dt = dt_off[c + 1] - dt_off[c];
        const int64_t n_gt = gt_off[c + 1] - gt_off[c];
        tm_box_iou(dt_flat + dt_off[c] * 4, n_dt, gt_flat + gt_off[c] * 4, n_gt,
                   crowd_flat + gt_off[c], out_flat + out_off[c]);
    }
}

// ---------------------------------------------------------------------------
// COCOeval greedy matcher: one (image, class) cell across T IoU thresholds.
// ious: (n_dt, n_gt) row-major; dt sorted by descending score; gt sorted
// ignore-last. Writes dt_matches/gt_matches (T, n_dt)/(T, n_gt) int64 of
// 1-based match ids (0 = unmatched) and dt_ignore (T, n_dt) uint8.
// Mirrors pycocotools COCOeval.evaluateImg semantics.
// ---------------------------------------------------------------------------
void tm_coco_match(const double* ious, int64_t n_dt, int64_t n_gt,
                   const uint8_t* gt_ignore, const uint8_t* gt_crowd,
                   const double* iou_thrs, int64_t T,
                   int64_t* dt_m, int64_t* gt_m, uint8_t* dt_ig) {
    for (int64_t t = 0; t < T; ++t) {
        const double thr = iou_thrs[t];
        int64_t* dtm = dt_m + t * n_dt;
        int64_t* gtm = gt_m + t * n_gt;
        uint8_t* dti = dt_ig + t * n_dt;
        for (int64_t d = 0; d < n_dt; ++d) {
            double iou = std::min(thr, 1.0 - 1e-10);
            int64_t match = -1;
            for (int64_t g = 0; g < n_gt; ++g) {
                if (gtm[g] > 0 && !gt_crowd[g]) continue;        // gt already matched (non-crowd)
                if (match > -1 && !gt_ignore[match] && gt_ignore[g]) break;  // moving to ignored gts: stop
                if (ious[d * n_gt + g] < iou) continue;
                iou = ious[d * n_gt + g];
                match = g;
            }
            if (match == -1) continue;
            dti[d] = gt_ignore[match];
            dtm[d] = match + 1;
            gtm[match] = d + 1;
        }
    }
}

// ---------------------------------------------------------------------------
// Fused COCOeval staging + matching: one call per epoch over (image, class)
// cells, each evaluated across A area ranges and T IoU thresholds. Replaces
// the per-cell Python staging (score argsort, per-area gt ignore-sort,
// matrix reorders) that dominates evaluation once IoU and matching are
// native. Cell c reads the UNordered full matrices:
//   ious_flat[iou_off[c] .. +D*G]  (row-major, detection-major)
//   scores/d_areas at d_off[c] (D), g_areas/crowd at g_off[c] (G)
// and writes, with D2 = min(D, cap):
//   order_flat[d2_off[c] .. +D2]          descending-score dt indices
//   matched/ignored_flat[d2_off[c]*A*T ..] laid out (A, T, D2) per cell
//   npos_flat[c*A .. +A]                  non-ignored gt count per area
// Semantics identical to per-cell tm_coco_match with staged inputs: gts sorted
// ignore-last per area, greedy threshold matching, unmatched dts outside
// the area range ignored.
// ---------------------------------------------------------------------------
void tm_coco_stage_match_batch(
    const double* ious_flat, const int64_t* iou_off,
    const double* scores_flat, const double* d_areas_flat, const int64_t* d_off,
    const double* g_areas_flat, const uint8_t* crowd_flat, const int64_t* g_off,
    int64_t n_cells,
    const double* area_lo, const double* area_hi, int64_t A,
    const double* iou_thrs, int64_t T, int64_t cap,
    const int64_t* d2_off,
    int64_t* order_flat, uint8_t* matched_flat, uint8_t* ignored_flat,
    int64_t* npos_flat) {
    std::vector<int64_t> gidx;
    std::vector<uint8_t> g_ign, gtm, d_ign;
    for (int64_t c = 0; c < n_cells; ++c) {
        const int64_t D = d_off[c + 1] - d_off[c];
        const int64_t G = g_off[c + 1] - g_off[c];
        const int64_t D2 = d2_off[c + 1] - d2_off[c];
        const double* ious = ious_flat + iou_off[c];
        const double* scores = scores_flat + d_off[c];
        const double* d_areas = d_areas_flat + d_off[c];
        const double* g_areas = g_areas_flat + g_off[c];
        const uint8_t* crowd = crowd_flat + g_off[c];
        int64_t* order = order_flat + d2_off[c];

        // descending-score stable order, truncated to cap; NaN scores sort
        // last (np.argsort(-scores) semantics) — mapping NaN to -inf keeps
        // the comparator a strict weak ordering
        std::vector<int64_t> full(D);
        for (int64_t i = 0; i < D; ++i) full[i] = i;
        const auto key = [&](int64_t i) {
            const double s = scores[i];
            return std::isnan(s) ? -std::numeric_limits<double>::infinity() : s;
        };
        std::stable_sort(full.begin(), full.end(),
                         [&](int64_t a, int64_t b) { return key(a) > key(b); });
        for (int64_t i = 0; i < D2; ++i) order[i] = full[i];

        if ((int64_t)gidx.size() < G) { gidx.resize(G); g_ign.resize(G); gtm.resize(G); }
        if ((int64_t)d_ign.size() < D2) d_ign.resize(D2);

        for (int64_t a = 0; a < A; ++a) {
            const double lo = area_lo[a], hi = area_hi[a];
            int64_t npos = 0;
            for (int64_t g = 0; g < G; ++g) {
                g_ign[g] = crowd[g] || g_areas[g] < lo || g_areas[g] > hi;
                if (!g_ign[g]) ++npos;
            }
            npos_flat[c * A + a] = npos;
            for (int64_t g = 0; g < G; ++g) gidx[g] = g;
            std::stable_sort(gidx.begin(), gidx.begin() + G,
                             [&](int64_t x, int64_t y) { return g_ign[x] < g_ign[y]; });
            for (int64_t i = 0; i < D2; ++i) {
                const double ar = d_areas[order[i]];
                d_ign[i] = ar < lo || ar > hi;
            }
            uint8_t* m_base = matched_flat + d2_off[c] * A * T + a * T * D2;
            uint8_t* i_base = ignored_flat + d2_off[c] * A * T + a * T * D2;
            for (int64_t t = 0; t < T; ++t) {
                const double thr = iou_thrs[t];
                uint8_t* dtm = m_base + t * D2;
                uint8_t* dti = i_base + t * D2;
                std::fill(gtm.begin(), gtm.begin() + G, 0);
                for (int64_t d = 0; d < D2; ++d) {
                    const double* iou_row = ious + order[d] * G;
                    double iou = std::min(thr, 1.0 - 1e-10);
                    int64_t match = -1;
                    for (int64_t gi = 0; gi < G; ++gi) {
                        const int64_t g = gidx[gi];
                        if (gtm[gi] && !crowd[g]) continue;
                        if (match > -1 && !g_ign[gidx[match]] && g_ign[g]) break;
                        if (iou_row[g] < iou) continue;
                        iou = iou_row[g];
                        match = gi;
                    }
                    if (match == -1) {
                        dti[d] = d_ign[d];  // unmatched dt outside area range
                        continue;
                    }
                    dti[d] = g_ign[gidx[match]];
                    dtm[d] = 1;
                    gtm[match] = 1;
                }
            }
        }
    }
}

}  // extern "C"
