// Native graph-build kernels for anemoi-models-tpu.
//
// The reference offloads its graph machinery to torch_geometric's compiled
// kernels (sort/scatter, ``khop_edges.py``); here the equivalent build-time
// work — CSR edge sorting, dense neighbor-table construction, icosahedron
// subdivision — is implemented in C++ for O1280-scale graphs (millions of
// nodes, ~1e8 edges), exposed through a plain C ABI consumed via ctypes
// (no pybind11 dependency). NumPy fallbacks live in graphs/*.py.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <cmath>
#include <unordered_map>
#include <vector>

extern "C" {

// Stable two-pass counting sort of edges by (dst, src): fills `perm` with the
// permutation that sorts the edge list, and `dst_ptr` (len num_dst+1) with
// CSR row offsets.
void sort_edges_csr(const int32_t* src, const int32_t* dst, int64_t num_edges,
                    int32_t num_src, int32_t num_dst, int64_t* perm,
                    int64_t* dst_ptr) {
  std::vector<int64_t> tmp(num_edges);
  // pass 1: stable counting sort by src
  {
    std::vector<int64_t> count(num_src + 1, 0);
    for (int64_t e = 0; e < num_edges; ++e) count[src[e] + 1]++;
    for (int32_t i = 0; i < num_src; ++i) count[i + 1] += count[i];
    for (int64_t e = 0; e < num_edges; ++e) tmp[count[src[e]]++] = e;
  }
  // pass 2: stable counting sort by dst
  {
    std::vector<int64_t> count(num_dst + 1, 0);
    for (int64_t e = 0; e < num_edges; ++e) count[dst[e] + 1]++;
    for (int32_t i = 0; i < num_dst; ++i) count[i + 1] += count[i];
    std::memcpy(dst_ptr, count.data(), sizeof(int64_t) * (num_dst + 1));
    std::vector<int64_t> pos(count.begin(), count.end());
    for (int64_t i = 0; i < num_edges; ++i) {
      int64_t e = tmp[i];
      perm[pos[dst[e]]++] = e;
    }
  }
}

// Dense neighbor tables from CSR-sorted edges: edge ids, source ids and a
// validity mask, each (num_dst, max_deg) row-major. Returns nothing; caller
// allocates. `max_deg` must be >= the true max in-degree.
void dense_tables(const int32_t* src_sorted, const int32_t* dst_sorted,
                  int64_t num_edges, int32_t num_dst, int32_t max_deg,
                  int32_t* edge_ids, int32_t* src_ids, uint8_t* mask) {
  std::memset(edge_ids, 0, sizeof(int32_t) * (int64_t)num_dst * max_deg);
  std::memset(src_ids, 0, sizeof(int32_t) * (int64_t)num_dst * max_deg);
  std::memset(mask, 0, sizeof(uint8_t) * (int64_t)num_dst * max_deg);
  int64_t e = 0;
  for (int32_t d = 0; d < num_dst; ++d) {
    int32_t k = 0;
    while (e < num_edges && dst_sorted[e] == d) {
      int64_t off = (int64_t)d * max_deg + k;
      edge_ids[off] = (int32_t)e;
      src_ids[off] = src_sorted[e];
      mask[off] = 1;
      ++e;
      ++k;
    }
  }
}

// Max in-degree of a CSR-sorted destination column.
int32_t max_in_degree(const int32_t* dst_sorted, int64_t num_edges,
                      int32_t num_dst) {
  int32_t best = 0;
  int64_t e = 0;
  for (int32_t d = 0; d < num_dst && e < num_edges; ++d) {
    int32_t k = 0;
    while (e < num_edges && dst_sorted[e] == d) { ++e; ++k; }
    if (k > best) best = k;
  }
  return best;
}

// One icosphere subdivision step. verts: (nv, 3) unit vectors; faces:
// (nf, 3) int64. Outputs: new_verts appended after the old ones (caller
// allocates nv + 3*nf/2 + ... upper bound = nv + 2*nf rows; actual count
// returned), new_faces (4*nf, 3).
int64_t subdivide(const double* verts, int64_t nv, const int64_t* faces,
                  int64_t nf, double* new_verts, int64_t* new_faces) {
  std::unordered_map<uint64_t, int64_t> midpoint;
  midpoint.reserve(nf * 2);
  std::memcpy(new_verts, verts, sizeof(double) * nv * 3);
  int64_t next = nv;

  auto mid = [&](int64_t a, int64_t b) -> int64_t {
    uint64_t key = a < b ? ((uint64_t)a << 32) | (uint64_t)b
                         : ((uint64_t)b << 32) | (uint64_t)a;
    auto it = midpoint.find(key);
    if (it != midpoint.end()) return it->second;
    double x = verts[a * 3] + verts[b * 3];
    double y = verts[a * 3 + 1] + verts[b * 3 + 1];
    double z = verts[a * 3 + 2] + verts[b * 3 + 2];
    double inv = 1.0 / std::sqrt(x * x + y * y + z * z);
    new_verts[next * 3] = x * inv;
    new_verts[next * 3 + 1] = y * inv;
    new_verts[next * 3 + 2] = z * inv;
    midpoint.emplace(key, next);
    return next++;
  };

  for (int64_t f = 0; f < nf; ++f) {
    int64_t a = faces[f * 3], b = faces[f * 3 + 1], c = faces[f * 3 + 2];
    int64_t ab = mid(a, b), bc = mid(b, c), ca = mid(c, a);
    int64_t* out = new_faces + f * 12;
    out[0] = a;  out[1] = ab; out[2] = ca;
    out[3] = b;  out[4] = bc; out[5] = ab;
    out[6] = c;  out[7] = ca; out[8] = bc;
    out[9] = ab; out[10] = bc; out[11] = ca;
  }
  return next;
}

// Stable counting sort of live gather positions by the row they read.
// ids: (P,) source row per position, -1 = dead/padded. Outputs:
//   counts      (num_rows) int64 — live positions per row (in-degree)
//   rows_sorted (>= n_live) int64 — row ids ascending
//   pos_sorted  (>= n_live) int64 — positions, stable (ascending) per row
// Returns n_live. This is the adjoint-table build's argsort+stack
// (graphs/partition.py:transpose_position_tables) without the O(P log P).
int64_t sort_positions_by_row(const int64_t* ids, int64_t P, int64_t num_rows,
                              int64_t* counts, int64_t* rows_sorted,
                              int64_t* pos_sorted) {
  std::memset(counts, 0, sizeof(int64_t) * num_rows);
  int64_t n_live = 0;
  for (int64_t p = 0; p < P; ++p) {
    int64_t r = ids[p];
    if (r >= 0) { counts[r]++; n_live++; }
  }
  std::vector<int64_t> offset(num_rows + 1, 0);
  for (int64_t r = 0; r < num_rows; ++r) offset[r + 1] = offset[r] + counts[r];
  for (int64_t p = 0; p < P; ++p) {
    int64_t r = ids[p];
    if (r < 0) continue;
    int64_t o = offset[r]++;
    rows_sorted[o] = r;
    pos_sorted[o] = p;
  }
  return n_live;
}

// Masked variant: positions are the row-major slots of an (n, cap) int32
// src-id table with a uint8 mask — the forward bucket layout — so the
// caller skips materializing a (P,) int64 where(mask, src, -1) vector.
int64_t sort_positions_by_row_masked(const int32_t* ids, const uint8_t* mask,
                                     int64_t P, int64_t num_rows,
                                     int64_t* counts, int64_t* rows_sorted,
                                     int64_t* pos_sorted) {
  std::memset(counts, 0, sizeof(int64_t) * num_rows);
  int64_t n_live = 0;
  for (int64_t p = 0; p < P; ++p) {
    if (mask[p]) { counts[ids[p]]++; n_live++; }
  }
  std::vector<int64_t> offset(num_rows + 1, 0);
  for (int64_t r = 0; r < num_rows; ++r) offset[r + 1] = offset[r] + counts[r];
  for (int64_t p = 0; p < P; ++p) {
    if (!mask[p]) continue;
    int64_t o = offset[ids[p]]++;
    rows_sorted[o] = ids[p];
    pos_sorted[o] = p;
  }
  return n_live;
}

// Fill one degree-bucket's padded tables (partition.py:
// bucketed_neighbor_tables inner loop): for each of `nb` destinations, copy
// its CSR run of sorted sources into a (nb, cap) row. Padded slots are 0
// with mask 0, matching the numpy layout exactly.
void fill_bucket_tables(const int32_t* src_sorted, const int64_t* starts,
                        const int32_t* node_ids, int64_t nb, int32_t cap,
                        int32_t* edge_ids, int32_t* src_ids, uint8_t* mask) {
  std::memset(edge_ids, 0, sizeof(int32_t) * nb * cap);
  std::memset(src_ids, 0, sizeof(int32_t) * nb * cap);
  std::memset(mask, 0, sizeof(uint8_t) * nb * cap);
  for (int64_t i = 0; i < nb; ++i) {
    int64_t d = node_ids[i];
    int64_t lo = starts[d], hi = starts[d + 1];
    int64_t row = i * cap;
    for (int64_t e = lo; e < hi; ++e) {
      int64_t off = row + (e - lo);
      edge_ids[off] = (int32_t)e;
      src_ids[off] = src_sorted[e];
      mask[off] = 1;
    }
  }
}

// LZ4 *block*-format decoder (doc/lz4_Block_format.md) — the codec inside
// blosc-lz4 chunks, which is what anemoi-datasets zarr stores use by
// default (training/zarr_store.py). Token = [literal-run | match-len-4]
// nibbles with 255-continuation extensions; 2-byte LE match offset; match
// copies may overlap (byte-wise copy is the defined semantics). Returns
// the decompressed byte count, or -1 on malformed input / capacity
// overflow — the caller treats -1 as a hard format error.
int64_t lz4_decompress_block(const uint8_t* src, int64_t src_len,
                             uint8_t* dst, int64_t dst_cap) {
  const uint8_t* ip = src;
  const uint8_t* iend = src + src_len;
  uint8_t* op = dst;
  uint8_t* oend = dst + dst_cap;
  while (ip < iend) {
    uint8_t token = *ip++;
    int64_t lit = token >> 4;
    if (lit == 15) {
      uint8_t b;
      do {
        if (ip >= iend) return -1;
        b = *ip++;
        lit += b;
      } while (b == 255);
    }
    if (ip + lit > iend || op + lit > oend) return -1;
    std::memcpy(op, ip, lit);
    ip += lit;
    op += lit;
    if (ip >= iend) break;  // last sequence carries literals only
    if (ip + 2 > iend) return -1;
    int64_t offset = (int64_t)ip[0] | ((int64_t)ip[1] << 8);
    ip += 2;
    if (offset == 0 || (op - dst) < offset) return -1;
    int64_t mlen = (token & 15) + 4;
    if ((token & 15) == 15) {
      uint8_t b;
      do {
        if (ip >= iend) return -1;
        b = *ip++;
        mlen += b;
      } while (b == 255);
    }
    if (op + mlen > oend) return -1;
    const uint8_t* match = op - offset;
    for (int64_t i = 0; i < mlen; ++i) op[i] = match[i];
    op += mlen;
  }
  return op - dst;
}

// BloscLZ block decoder (c-blosc's default inner codec, blosclz.c). Stream
// of control bytes: ctrl < 32 is a literal run of ctrl+1 bytes; otherwise a
// match with length nibble ctrl>>5 (copy length (ctrl>>5)+2, 255-continued
// extension when the nibble is 7 -> 9+sum) and distance
// ((ctrl&31)<<8) + code + 1, where code==255 with a saturated high field
// escapes to a 16-bit far offset biased by MAX_DISTANCE. The first byte's
// high bits are ignored (streams open with a literal run). Match copies are
// byte-wise (distance-1 runs = RLE of the previous byte). Returns the
// decoded byte count or -1 on malformed input / capacity overflow.
int64_t blosclz_decompress_block(const uint8_t* src, int64_t src_len,
                                 uint8_t* dst, int64_t dst_cap) {
  const int64_t MAX_DISTANCE = 8191;
  if (src_len <= 0) return src_len == 0 ? 0 : -1;
  const uint8_t* ip = src;
  const uint8_t* iend = src + src_len;
  uint8_t* op = dst;
  uint8_t* oend = dst + dst_cap;
  int32_t ctrl = (*ip++) & 31;
  bool more = true;
  while (more) {
    if (ctrl >= 32) {
      int64_t len = (ctrl >> 5) - 1;
      int64_t ofs = (int64_t)(ctrl & 31) << 8;
      if (len == 6) {
        uint8_t ext;
        do {
          if (ip >= iend) return -1;
          ext = *ip++;
          len += ext;
        } while (ext == 255);
      }
      if (ip >= iend) return -1;
      uint8_t code = *ip++;
      int64_t dist = ofs + code;
      if (code == 255 && ofs == ((int64_t)31 << 8)) {
        if (ip + 2 > iend) return -1;
        dist = (((int64_t)ip[0] << 8) | ip[1]) + MAX_DISTANCE;
        ip += 2;
      }
      if (ip < iend) ctrl = *ip++; else more = false;
      len += 3;
      int64_t d = dist + 1;
      if (d > op - dst || op + len > oend) return -1;
      const uint8_t* ref = op - d;
      for (int64_t k = 0; k < len; ++k) op[k] = ref[k];
      op += len;
    } else {
      int64_t len = ctrl + 1;
      if (ip + len > iend || op + len > oend) return -1;
      std::memcpy(op, ip, len);
      ip += len;
      op += len;
      if (ip < iend) ctrl = *ip++; else more = false;
    }
  }
  return op - dst;
}

}  // extern "C"
