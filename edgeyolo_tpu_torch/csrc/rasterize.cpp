// Polygon scan fill for the segment task's masks (host C++, no card).
//
// The JAX package rasterises each instance polygon with cv2.fillPoly (8-
// connected, integer vertices, no sub-pixel shift); the port imports no
// cv2, and a ring of boundary pixels moves mask mAP by whole points, so
// this file reproduces that fill's rules pixel for pixel:
//
// - the outline: an 8-connected Bresenham line between consecutive
//   vertices (the last to the first too), walked left to right, clipped to
//   the image by the Cohen-Sutherland rule with the intersection truncated
//   toward zero;
// - the interior: an edge list scan over rows y0 <= y < y1 of each
//   non-horizontal edge, x in 16.16 fixed point stepping by the truncated
//   slope; an edge that leaves the image takes the slope of its clipped
//   segment and starts from the clipped end projected back to its vertex
//   row (a segment that clips to one row keeps its vertex rows, with the
//   clipped x at both ends: a vertical edge); edges kept in an active list
//   sorted by x (merge-insert at their first row, then bubble passes after
//   every row until a pass exchanges nothing), consecutive pairs filled
//   from ceil(left) to floor(right) inclusive, clipped to the image.
//
// C interface (ctypes, data/rasterize.py):
//   void eyr_fill_poly(uint8_t* img, int h, int w, const int32_t* xy, int n, int color)
// fills one polygon of n (x, y) vertices into a row-major h x w uint8 image.

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cstring>
#include <utility>
#include <vector>

namespace {

constexpr int kShift = 16;
constexpr int64_t kCeil = (int64_t(1) << kShift) - 1;  // a span starts at ceil(left)

struct Edge {
    int y0, y1;
    int64_t x, dx;
    Edge* next;
};

// Clip the segment to [0, w) x [0, h); false when nothing of it is inside.
bool clip_line(int64_t w, int64_t h, int64_t& x1, int64_t& y1, int64_t& x2, int64_t& y2) {
    if (w <= 0 || h <= 0) return false;
    const int64_t right = w - 1, bottom = h - 1;
    int c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8;
    int c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8;
    if ((c1 & c2) == 0 && (c1 | c2) != 0) {
        int64_t a;
        if (c1 & 12) {
            a = c1 < 8 ? 0 : bottom;
            x1 += (int64_t)((double)(a - y1) * (x2 - x1) / (y2 - y1));
            y1 = a;
            c1 = (x1 < 0) + (x1 > right) * 2;
        }
        if (c2 & 12) {
            a = c2 < 8 ? 0 : bottom;
            x2 += (int64_t)((double)(a - y2) * (x2 - x1) / (y2 - y1));
            y2 = a;
            c2 = (x2 < 0) + (x2 > right) * 2;
        }
        if ((c1 & c2) == 0 && (c1 | c2) != 0) {
            if (c1) {
                a = c1 == 1 ? 0 : right;
                y1 += (int64_t)((double)(a - x1) * (y2 - y1) / (x2 - x1));
                x1 = a;
                c1 = 0;
            }
            if (c2) {
                a = c2 == 1 ? 0 : right;
                y2 += (int64_t)((double)(a - x2) * (y2 - y1) / (x2 - x1));
                x2 = a;
                c2 = 0;
            }
        }
    }
    return (c1 | c2) == 0;
}

// 8-connected line from (x1, y1) to (x2, y2), walked left to right.
void line8(uint8_t* img, int h, int w, int64_t x1, int64_t y1, int64_t x2, int64_t y2,
           uint8_t color) {
    if ((uint64_t)x1 >= (uint64_t)w || (uint64_t)x2 >= (uint64_t)w ||
        (uint64_t)y1 >= (uint64_t)h || (uint64_t)y2 >= (uint64_t)h) {
        if (!clip_line(w, h, x1, y1, x2, y2)) return;
    }
    int64_t dx = x2 - x1, dy = y2 - y1;
    int64_t major = 1, minor = 1;  // steps along x, then y (swapped for a steep line)
    if (dx < 0) {
        dx = -dx;
        dy = -dy;
        std::swap(x1, x2);
        std::swap(y1, y2);
    }
    if (dy < 0) {
        dy = -dy;
        minor = -1;
    }
    const bool vert = dy > dx;
    if (vert) {
        std::swap(dx, dy);
        std::swap(major, minor);
    }
    int64_t err = dx - (dy + dy);
    const int64_t plus = dx + dx, minus = -(dy + dy);
    int64_t x = x1, y = y1;
    for (int64_t i = 0; i <= dx; i++) {
        img[y * w + x] = color;
        const bool step = err < 0;
        err += minus + (step ? plus : 0);
        if (vert) {  // y always moves (by `major`, the y step), x when err was negative
            y += major;
            if (step) x += minor;
        } else {
            x += major;
            if (step) y += minor;
        }
    }
}

bool edge_less(const Edge& a, const Edge& b) {
    if (a.y0 != b.y0) return a.y0 < b.y0;
    if (a.x != b.x) return a.x < b.x;
    return a.dx < b.dx;
}

void fill_edges(uint8_t* img, int h, int w, std::vector<Edge>& edges, uint8_t color) {
    const int total = (int)edges.size();
    if (total < 2) return;
    int y_max = INT_MIN, y_min = INT_MAX;
    int64_t x_max = -1, x_min = INT64_MAX;
    for (const Edge& e : edges) {
        const int64_t x1 = e.x + (int64_t)(e.y1 - e.y0) * e.dx;
        y_min = std::min(y_min, e.y0);
        y_max = std::max(y_max, e.y1);
        x_min = std::min({x_min, e.x, x1});
        x_max = std::max({x_max, e.x, x1});
    }
    if (y_max < 0 || y_min >= h || x_max < 0 || x_min >= ((int64_t)w << kShift)) return;
    std::sort(edges.begin(), edges.end(), edge_less);
    Edge head{INT_MAX, 0, 0, 0, nullptr};
    edges.push_back(head);  // the sentinel past the last edge (y0 never reached)
    int i = 0;
    Edge* e = &edges[0];
    y_max = std::min(y_max, h);
    for (int y = e->y0; y < y_max; y++) {
        Edge *last, *prelast, *keep_prelast;
        int draw = 0;
        const bool clipline = y < 0;
        prelast = &head;
        last = head.next;
        while (last || e->y0 == y) {
            if (last && last->y1 == y) {  // the edge ends above this row
                prelast->next = last->next;
                last = last->next;
                continue;
            }
            keep_prelast = prelast;
            if (last && (e->y0 > y || last->x < e->x)) {
                prelast = last;
                last = last->next;
            } else if (i < total) {  // an edge starting on this row joins the list
                prelast->next = e;
                e->next = last;
                prelast = e;
                e = &edges[++i];
            } else {
                break;
            }
            if (draw) {
                if (!clipline) {
                    int64_t x1, x2;
                    if (keep_prelast->x > prelast->x) {
                        x1 = (prelast->x + kCeil) >> kShift;
                        x2 = keep_prelast->x >> kShift;
                    } else {
                        x1 = (keep_prelast->x + kCeil) >> kShift;
                        x2 = prelast->x >> kShift;
                    }
                    if (x1 < w && x2 >= 0) {
                        x1 = std::max<int64_t>(x1, 0);
                        x2 = std::min<int64_t>(x2, w - 1);
                        std::memset(img + (int64_t)y * w + x1, color, (size_t)(x2 - x1 + 1));
                    }
                }
                keep_prelast->x += keep_prelast->dx;
                prelast->x += prelast->dx;
            }
            draw ^= 1;
        }
        // bubble the active list back into x order
        keep_prelast = nullptr;
        do {
            prelast = &head;
            last = head.next;
            Edge* last_exchange = nullptr;
            while (last != keep_prelast && last->next != nullptr) {
                Edge* te = last->next;
                if (last->x > te->x) {
                    prelast->next = te;
                    last->next = te->next;
                    te->next = last;
                    prelast = te;
                    last_exchange = prelast;
                } else {
                    prelast = last;
                    last = te;
                }
            }
            if (last_exchange == nullptr) break;
            keep_prelast = last_exchange;
        } while (keep_prelast != head.next && keep_prelast != &head);
    }
}

}  // namespace

extern "C" void eyr_fill_poly(uint8_t* img, int h, int w, const int32_t* xy, int n, int color) {
    if (n <= 0) return;
    std::vector<Edge> edges;
    edges.reserve(n + 1);
    int64_t px = xy[2 * (n - 1)], py = xy[2 * (n - 1) + 1];
    for (int i = 0; i < n; i++) {
        const int64_t cx = xy[2 * i], cy = xy[2 * i + 1];
        line8(img, h, w, px, py, cx, cy, (uint8_t)color);
        if (py != cy) {
            // an edge that leaves the image runs along its clipped segment:
            // that segment's slope, from its clipped end projected back to
            // the vertex row
            int64_t ax = px, ay = py, bx = cx, by = cy;
            if ((uint64_t)px >= (uint64_t)w || (uint64_t)cx >= (uint64_t)w ||
                (uint64_t)py >= (uint64_t)h || (uint64_t)cy >= (uint64_t)h) {
                int64_t tx0 = px, ty0 = py, tx1 = cx, ty1 = cy;
                clip_line(w, h, tx0, ty0, tx1, ty1);
                ax = tx0, bx = tx1;
                if (ty0 != ty1) {
                    ay = ty0, by = ty1;
                }
            }
            Edge ed;
            ed.dx = ((bx - ax) << kShift) / (by - ay);
            if (py < cy) {
                ed.y0 = (int)py;
                ed.y1 = (int)cy;
                ed.x = (ax << kShift) + (py - ay) * ed.dx;
            } else {
                ed.y0 = (int)cy;
                ed.y1 = (int)py;
                ed.x = (bx << kShift) + (cy - by) * ed.dx;
            }
            ed.next = nullptr;
            edges.push_back(ed);
        }
        px = cx;
        py = cy;
    }
    fill_edges(img, h, w, edges, (uint8_t)color);
}
