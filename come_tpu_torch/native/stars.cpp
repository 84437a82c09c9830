// The star layout (sampling/stars.py::build_star_layout) in two calls.
//
// The port's C++ form of come_tpu/sampling/stars.py:86-133, which the JAX
// package runs in numpy and Python: come_star_sort orients each edge to its
// higher-degree end and sorts the arcs by source (a counting sort, stable
// as numpy's argsort(kind="stable") is, so the order is the same), and
// come_star_pack runs the greedy loop that packs each source's fan-out into
// rows, one pass per segment of at most max_fanout neighbours (about 2e4
// passes at BlogCatalog's 334 190 edges, 1e6 at synthetic-10m's
// 10 002 609).  The arithmetic is the Python's, so the slots and meta are
// the same, bit for bit.
//
// Build (come_tpu_torch/native/build.py does this at first use):
//   g++ -O3 -std=c++17 -shared -fPIC -o libcomestars.so stars.cpp

#include <algorithm>
#include <cstdint>
#include <vector>

// Orient edge e (u[e], v[e]) to the endpoint of higher degree (ties to the
// smaller id) as its source and sort the arcs by source, stably: dst[E] gets
// the sorted destinations, and for the n_seg sources with arcs, in
// increasing id, hubs[k] the id and [starts[k], ends[k]) its arcs.  Ids are
// in [0, num_nodes); hubs, starts and ends hold num_nodes entries.
// Returns n_seg.
extern "C" int64_t come_star_sort(const int32_t* u, const int32_t* v,
                                  int64_t E, int64_t num_nodes, int32_t* dst,
                                  int32_t* hubs, int64_t* starts,
                                  int64_t* ends) {
  std::vector<int32_t> deg(num_nodes, 0);
  std::vector<int64_t> pos(num_nodes, 0);
  for (int64_t e = 0; e < E; ++e) {
    ++deg[u[e]];
    ++deg[v[e]];
  }
  auto source = [&](int64_t e) {
    const int32_t a = u[e], b = v[e];
    return deg[a] > deg[b] || (deg[a] == deg[b] && a < b) ? a : b;
  };
  for (int64_t e = 0; e < E; ++e) ++pos[source(e)];
  int64_t n_seg = 0, off = 0;
  for (int64_t n = 0; n < num_nodes; ++n) {
    if (pos[n] == 0) continue;
    hubs[n_seg] = static_cast<int32_t>(n);
    starts[n_seg] = off;
    off += pos[n];
    ends[n_seg] = off;
    pos[n] = starts[n_seg];  // from here: the next free position
    ++n_seg;
  }
  for (int64_t e = 0; e < E; ++e) {
    const int32_t a = source(e);
    dst[pos[a]++] = a == u[e] ? v[e] : u[e];
  }
  return n_seg;
}

// Pack the n_seg sources' sorted fan-outs into rows of row_slots slots:
// source k is hub hubs[k] with neighbours dst[starts[k]:ends[k]]; a segment
// is the hub's slot (meta seg*2 + 1) and up to max_fanout neighbour slots
// (meta seg*2), never across a row; a row with fewer than 2 free slots is
// left as it is (the caller's pads: slot 0, meta -2).  seg is row-local:
// the segment's first slot in its row over 2.  slots and meta hold cap
// entries.  Returns the slots used, or -1 if cap would be passed.
extern "C" int64_t come_star_pack(const int32_t* hubs, const int64_t* starts,
                                  const int64_t* ends, int64_t n_seg,
                                  const int32_t* dst, int32_t row_slots,
                                  int32_t max_fanout, int32_t* slots,
                                  int32_t* meta, int64_t cap) {
  int64_t c = 0;
  for (int64_t k = 0; k < n_seg; ++k) {
    const int32_t hub = hubs[k];
    int64_t lo = starts[k];
    const int64_t hi = ends[k];
    while (lo < hi) {
      int64_t space = row_slots - c % row_slots;
      if (space < 2) {  // no room for hub + >= 1 neighbour: pad out the row
        c += space;
        space = row_slots;
      }
      const int64_t m =
          std::min<int64_t>(std::min<int64_t>(hi - lo, space - 1), max_fanout);
      if (c + 1 + m > cap) return -1;
      const int32_t seg = static_cast<int32_t>((c % row_slots) / 2);
      slots[c] = hub;
      meta[c] = seg * 2 + 1;
      for (int64_t q = 0; q < m; ++q) {
        slots[c + 1 + q] = dst[lo + q];
        meta[c + 1 + q] = seg * 2;
      }
      c += m + 1;
      lo += m;
    }
  }
  return c;
}
