// Native region-growing core for SuperPixelPlaneClusterModule (the port's
// own copy of cartslam_tpu/native/cluster.cpp; same algorithm and rule).
//
// The reference runs this clustering on the host in C++
// (src/modules/planecluster.cpp:98-167); the per-label plane fits run on
// the device.  The same algorithm as models/planecluster.grow_clusters_python,
// same merge rule: a neighbor joins when |d sin yaw| + |d cos yaw| <
// yaw_thresh, same for pitch, and |d offset| < d_thresh; clusters below
// min_cluster labels are dropped; a label already in a cluster keeps the
// more similar assignment.
//
// Built by g++ at first use into build/cartslam_tpu_torch/ (native/build.py)
// and loaded with ctypes (native/__init__.py).

#include <cstdint>
#include <cmath>
#include <vector>

extern "C" {

// Returns the number of clusters; assignments[l] = 0 (none) or 1-based
// cluster id; cluster_planes receives [max_clusters, 4] rows.
int64_t cart_grow_clusters(
    int64_t num_labels,
    const int64_t* edge_a, const int64_t* edge_b, int64_t num_edges,
    const double* planes,      // [L, 4]
    const uint8_t* ok,         // [L]
    double yaw_pitch_thresh,   // 0.2
    double d_thresh,           // 3.0
    int64_t min_cluster,
    int64_t* assignments,      // [L] out, zero-initialized by caller
    double* cluster_planes,    // [L, 4] out (at most L clusters)
    int64_t max_clusters)
{
    std::vector<std::vector<int32_t>> neigh(num_labels);
    for (int64_t e = 0; e < num_edges; e++) {
        int64_t a = edge_a[e], b = edge_b[e];
        if (a < 0 || b < 0 || a >= num_labels || b >= num_labels) continue;
        neigh[a].push_back((int32_t)b);
        neigh[b].push_back((int32_t)a);
    }

    // Orientation stats (planecluster.cpp:57-68).
    std::vector<double> ys(num_labels), yc(num_labels), ps(num_labels),
        pc(num_labels), dd(num_labels);
    for (int64_t l = 0; l < num_labels; l++) {
        double a = planes[4 * l], b = planes[4 * l + 1], c = planes[4 * l + 2];
        double len = std::sqrt(a * a + b * b + c * c);
        double yaw = std::atan2(b, a);
        double pitch = std::atan2(c, len > 1e-12 ? len : 1e-12);
        ys[l] = std::sin(yaw);  yc[l] = std::cos(yaw);
        ps[l] = std::sin(pitch); pc[l] = std::cos(pitch);
        dd[l] = planes[4 * l + 3];
    }

    int64_t n_clusters = 0;
    std::vector<int32_t> frontier;
    std::vector<uint8_t> seen(num_labels);
    std::vector<int32_t> similar;

    for (int64_t seed = 0; seed < num_labels; seed++) {
        if (assignments[seed] != 0 || !ok[seed]) continue;
        similar.clear();
        similar.push_back((int32_t)seed);
        std::fill(seen.begin(), seen.end(), 0);
        seen[seed] = 1;
        frontier.clear();
        for (int32_t nb : neigh[seed]) {
            if (!seen[nb]) { seen[nb] = 1; frontier.push_back(nb); }
        }
        while (!frontier.empty()) {
            int32_t other = frontier.back();
            frontier.pop_back();
            if (!ok[other]) continue;
            double yaw_diff = std::fabs(ys[seed] - ys[other]) +
                              std::fabs(yc[seed] - yc[other]);
            double pitch_diff = std::fabs(ps[seed] - ps[other]) +
                                std::fabs(pc[seed] - pc[other]);
            double d_diff = std::fabs(dd[seed] - dd[other]);
            if (yaw_diff < yaw_pitch_thresh && pitch_diff < yaw_pitch_thresh &&
                d_diff < d_thresh) {
                int64_t cur = assignments[other];
                if (cur != 0) {
                    // Keep the more similar assignment
                    // (planecluster.cpp:131-141).
                    const double* cs = &cluster_planes[4 * (cur - 1)];
                    double cl = std::sqrt(cs[0] * cs[0] + cs[1] * cs[1] +
                                          cs[2] * cs[2]);
                    double cyaw = std::atan2(cs[1], cs[0]);
                    double cy = std::fabs(std::sin(cyaw) - ys[other]) +
                                std::fabs(std::cos(cyaw) - yc[other]);
                    double cp_ = std::atan2(cs[2], cl > 1e-12 ? cl : 1e-12);
                    double cp = std::fabs(std::sin(cp_) - ps[other]) +
                                std::fabs(std::cos(cp_) - pc[other]);
                    if (cy + cp + d_diff < yaw_diff + pitch_diff + d_diff)
                        continue;
                }
                similar.push_back(other);
                for (int32_t nb : neigh[other]) {
                    if (!seen[nb]) { seen[nb] = 1; frontier.push_back(nb); }
                }
            }
        }
        if ((int64_t)similar.size() < min_cluster) continue;
        if (n_clusters >= max_clusters) break;
        for (int k = 0; k < 4; k++)
            cluster_planes[4 * n_clusters + k] = planes[4 * seed + k];
        n_clusters++;
        for (int32_t l : similar) assignments[l] = n_clusters;
    }
    return n_clusters;
}

}  // extern "C"
