// Host-side evaluation kernels (C++), the port's own copy of the JAX
// package's egtr_tpu/native/bbox_kernels.cpp.
//
// Native replacement for the reference's Cython box kernel
// (lib/fpn/box_intersections_cpu/bbox.pyx:15-60) plus the hot inner loop of
// the scene-graph recall matcher (_compute_pred_matches,
// lib/evaluation/sg_eval.py:281-328). Built at first use by
// egtr_tpu_torch/native/__init__.py (g++ -O3 -shared -fPIC) and bound via
// ctypes; the numpy loop in evaluation/sg_eval.py is its plain version.
//
// Conventions follow the reference exactly: the "+1 pixel" IoU
// (width = x2 - x1 + 1).

#include <cstdint>
#include <cstring>
#include <algorithm>

extern "C" {

// Pairwise IoU with the +1 convention. boxes are [n,4] / [k,4] float64 xyxy.
void bbox_overlaps_plus1(const double* boxes, int64_t n,
                         const double* query_boxes, int64_t k,
                         double* out) {
    for (int64_t j = 0; j < k; ++j) {
        const double* q = query_boxes + 4 * j;
        const double box_area = (q[2] - q[0] + 1) * (q[3] - q[1] + 1);
        for (int64_t i = 0; i < n; ++i) {
            const double* b = boxes + 4 * i;
            const double iw = std::min(b[2], q[2]) - std::max(b[0], q[0]) + 1;
            double v = 0.0;
            if (iw > 0) {
                const double ih =
                    std::min(b[3], q[3]) - std::max(b[1], q[1]) + 1;
                if (ih > 0) {
                    const double ua =
                        (b[2] - b[0] + 1) * (b[3] - b[1] + 1) + box_area -
                        iw * ih;
                    v = iw * ih / ua;
                }
            }
            out[i * k + j] = v;
        }
    }
}

// Scene-graph triplet matching: for each GT triplet, mark which predicted
// triplets match by exact (s_cls, p, o_cls) equality and IoU >= thresh on
// both boxes (sg_eval.py:281-328, graph-agnostic part). Output is a dense
// [n_gt, n_pred] uint8 match matrix.
void triplet_matches(const int64_t* gt_triplets,     // [n_gt, 3]
                     const double* gt_boxes,          // [n_gt, 8]
                     int64_t n_gt,
                     const int64_t* pred_triplets,    // [n_pred, 3]
                     const double* pred_boxes,        // [n_pred, 8]
                     int64_t n_pred,
                     double iou_thresh,
                     int phrdet,
                     uint8_t* out) {                  // [n_gt, n_pred]
    std::memset(out, 0, n_gt * n_pred);
    for (int64_t g = 0; g < n_gt; ++g) {
        const int64_t* gt = gt_triplets + 3 * g;
        const double* gb = gt_boxes + 8 * g;
        for (int64_t p = 0; p < n_pred; ++p) {
            const int64_t* pt = pred_triplets + 3 * p;
            if (gt[0] != pt[0] || gt[1] != pt[1] || gt[2] != pt[2]) continue;
            const double* pb = pred_boxes + 8 * p;
            bool ok;
            if (phrdet) {
                // union boxes
                double gu[4] = {std::min(gb[0], gb[4]), std::min(gb[1], gb[5]),
                                std::max(gb[2], gb[6]), std::max(gb[3], gb[7])};
                double pu[4] = {std::min(pb[0], pb[4]), std::min(pb[1], pb[5]),
                                std::max(pb[2], pb[6]), std::max(pb[3], pb[7])};
                double iou = 0.0;
                bbox_overlaps_plus1(pu, 1, gu, 1, &iou);
                ok = iou >= iou_thresh;
            } else {
                double iou_s = 0.0, iou_o = 0.0;
                bbox_overlaps_plus1(pb, 1, gb, 1, &iou_s);
                bbox_overlaps_plus1(pb + 4, 1, gb + 4, 1, &iou_o);
                ok = iou_s >= iou_thresh && iou_o >= iou_thresh;
            }
            if (ok) out[g * n_pred + p] = 1;
        }
    }
}

}  // extern "C"
