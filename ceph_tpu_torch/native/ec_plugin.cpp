// libec_native: the framework's native-code erasure-code plugin.
//
// Implements the reference's dlopen plugin ABI (ErasureCodePlugin.cc:126-180 /
// ErasureCodePlugin.h:24-27): the loader dlopens libec_<name>.so, checks
// __erasure_code_version() against its own version string, calls
// __erasure_code_init(name, directory), and then asks for the registered
// entry points. The reference's plugins register a C++ factory with an
// in-process registry; here registration is exposing a C vtable
// (__erasure_code_ops) the Python loader binds with ctypes — same contract
// (init that "forgets" to register is detected), C ABI instead of C++.
//
// The codec is a straightforward GF(2^8) matrix RS coder over the same
// matrix families as the Python/TPU `isa` codec (gf_gen_rs_matrix /
// gf_gen_cauchy1_matrix semantics, ErasureCodeIsa.cc:384-393), so its output
// is asserted bit-identical to the TPU kernels in tests — the CPU fallback
// backend for hosts without an accelerator, and the in-repo native analogue
// of the reference's vendored ISA-L/jerasure codecs.
//
// Build: ceph_tpu/native/build.py (g++ -O3 -shared -fPIC).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// -- GF(2^8), polynomial 0x11d (matches ceph_tpu.ops.gf) ---------------------

uint8_t gf_exp[512];
uint8_t gf_log[256];
uint8_t gf_inv_tbl[256];
bool tables_ready = false;

void build_tables() {
  if (tables_ready) return;
  int x = 1;
  for (int i = 0; i < 255; i++) {
    gf_exp[i] = (uint8_t)x;
    gf_log[x] = (uint8_t)i;
    x <<= 1;
    if (x & 0x100) x ^= 0x11d;
  }
  for (int i = 255; i < 512; i++) gf_exp[i] = gf_exp[i - 255];
  gf_log[0] = 0;
  gf_inv_tbl[0] = 0;
  for (int i = 1; i < 256; i++) gf_inv_tbl[i] = gf_exp[255 - gf_log[i]];
  tables_ready = true;
}

inline uint8_t gf_mul(uint8_t a, uint8_t b) {
  if (!a || !b) return 0;
  return gf_exp[gf_log[a] + gf_log[b]];
}

inline uint8_t gf_div(uint8_t a, uint8_t b) {
  if (!a) return 0;
  return gf_exp[(gf_log[a] + 255 - gf_log[b]) % 255];
}

// -- coding matrices (ErasureCodeIsa.cc:384-393 semantics) -------------------

// gf_gen_rs_matrix parity rows: row i = powers of 2^i
void vandermonde_parity(int k, int m, uint8_t* out) {
  uint8_t gen = 1;
  for (int i = 0; i < m; i++) {
    uint8_t p = 1;
    for (int j = 0; j < k; j++) {
      out[i * k + j] = p;
      p = gf_mul(p, gen);
    }
    gen = gf_mul(gen, 2);
  }
}

// gf_gen_cauchy1_matrix parity rows: a[i][j] = inv((k+i) ^ j)
void cauchy_parity(int k, int m, uint8_t* out) {
  for (int i = 0; i < m; i++)
    for (int j = 0; j < k; j++)
      out[i * k + j] = gf_inv_tbl[(uint8_t)((k + i) ^ j)];
}

// Gauss-Jordan inversion over GF(2^8); returns false when singular
bool gf_invert(std::vector<uint8_t>& a, int n, std::vector<uint8_t>& inv) {
  inv.assign(n * n, 0);
  for (int i = 0; i < n; i++) inv[i * n + i] = 1;
  for (int col = 0; col < n; col++) {
    int pivot = -1;
    for (int row = col; row < n; row++)
      if (a[row * n + col]) { pivot = row; break; }
    if (pivot < 0) return false;
    if (pivot != col) {
      for (int j = 0; j < n; j++) {
        std::swap(a[col * n + j], a[pivot * n + j]);
        std::swap(inv[col * n + j], inv[pivot * n + j]);
      }
    }
    uint8_t d = a[col * n + col];
    for (int j = 0; j < n; j++) {
      a[col * n + j] = gf_div(a[col * n + j], d);
      inv[col * n + j] = gf_div(inv[col * n + j], d);
    }
    for (int row = 0; row < n; row++) {
      uint8_t f = a[row * n + col];
      if (row == col || !f) continue;
      for (int j = 0; j < n; j++) {
        a[row * n + j] ^= gf_mul(f, a[col * n + j]);
        inv[row * n + j] ^= gf_mul(f, inv[col * n + j]);
      }
    }
  }
  return true;
}

// -- codec instances ---------------------------------------------------------

struct Codec {
  int k = 0, m = 0;
  std::vector<uint8_t> gen;  // (k+m, k) systematic generator
};

std::vector<Codec*> instances;

// region op: out[.] ^= gf_mul(c, in[.]) via a 256-byte product table
void mul_acc_region(uint8_t c, const uint8_t* in, uint8_t* out, size_t len) {
  if (!c) return;
  uint8_t tbl[256];
  tbl[0] = 0;
  for (int v = 1; v < 256; v++) tbl[v] = gf_exp[gf_log[c] + gf_log[v]];
  for (size_t i = 0; i < len; i++) out[i] ^= tbl[in[i]];
}

}  // namespace

extern "C" {

// version handshake (reference: __erasure_code_version vs CEPH_GIT_NICE_VER,
// ErasureCodePlugin.cc:140-149); build.py injects the package version so
// there is a single source of truth (ceph_tpu.__version__)
#ifndef CEPH_TPU_PLUGIN_VERSION
#define CEPH_TPU_PLUGIN_VERSION "ceph-tpu-unversioned"
#endif
const char* __erasure_code_version() { return CEPH_TPU_PLUGIN_VERSION; }

static bool initialized = false;

int __erasure_code_init(const char* plugin_name, const char* directory) {
  (void)plugin_name;
  (void)directory;
  build_tables();
  initialized = true;
  return 0;
}

// create a codec: technique 0 = vandermonde (reed_sol_van), 1 = cauchy.
// Returns a handle >= 0, or -EINVAL (-22) on bad parameters.
int ec_create(int k, int m, int technique) {
  if (!initialized || k < 2 || m < 1 || k + m > 256) return -22;
  if (technique != 0 && technique != 1) return -22;
  Codec* c = new Codec;
  c->k = k;
  c->m = m;
  c->gen.assign((k + m) * k, 0);
  for (int i = 0; i < k; i++) c->gen[i * k + i] = 1;
  if (technique == 0)
    vandermonde_parity(k, m, c->gen.data() + k * k);
  else
    cauchy_parity(k, m, c->gen.data() + k * k);
  instances.push_back(c);
  return (int)instances.size() - 1;
}

void ec_destroy(int h) {
  if (h >= 0 && h < (int)instances.size() && instances[h]) {
    delete instances[h];
    instances[h] = nullptr;
  }
}

// data: k contiguous chunks of chunk_len; parity: m contiguous chunks (out)
int ec_encode(int h, const uint8_t* data, uint8_t* parity, size_t chunk_len) {
  if (h < 0 || h >= (int)instances.size() || !instances[h]) return -22;
  Codec* c = instances[h];
  std::memset(parity, 0, (size_t)c->m * chunk_len);
  for (int i = 0; i < c->m; i++)
    for (int j = 0; j < c->k; j++)
      mul_acc_region(c->gen[(c->k + i) * c->k + j], data + j * chunk_len,
                     parity + i * chunk_len, chunk_len);
  return 0;
}

// Rebuild `targets` from the first k of `present` (logical chunk indices,
// ascending): survivors are n_present contiguous chunks in `present` order.
// Mirrors the reference's decode-table construction (ErasureCodeIsa.cc:
// 253-302): invert the survivor rows of the generator, then lost-data rows
// come from the inverse and lost-coding rows from gen_row @ inverse.
int ec_decode(int h, const int* present, int n_present, const int* targets,
              int n_targets, const uint8_t* survivors, uint8_t* out,
              size_t chunk_len) {
  if (h < 0 || h >= (int)instances.size() || !instances[h]) return -22;
  Codec* c = instances[h];
  int k = c->k;
  if (n_present < k) return -5;  // EIO: not enough survivors
  std::vector<uint8_t> b(k * k);
  for (int r = 0; r < k; r++)
    for (int j = 0; j < k; j++) b[r * k + j] = c->gen[present[r] * k + j];
  std::vector<uint8_t> inv;
  if (!gf_invert(b, k, inv)) return -5;
  for (int t = 0; t < n_targets; t++) {
    std::vector<uint8_t> row(k);
    if (targets[t] < k) {
      for (int j = 0; j < k; j++) row[j] = inv[targets[t] * k + j];
    } else {
      for (int j = 0; j < k; j++) {
        uint8_t acc = 0;
        for (int l = 0; l < k; l++)
          acc ^= gf_mul(c->gen[targets[t] * k + l], inv[l * k + j]);
        row[j] = acc;
      }
    }
    uint8_t* dst = out + (size_t)t * chunk_len;
    std::memset(dst, 0, chunk_len);
    for (int j = 0; j < k; j++)
      mul_acc_region(row[j], survivors + (size_t)j * chunk_len, dst,
                     chunk_len);
  }
  return 0;
}

// registration: the loader asks for the ops table after init; returning the
// entry points is this ABI's equivalent of the reference plugin calling
// registry.add() — a plugin whose init "succeeds" but exposes no ops is
// rejected with the reference's "did not register" error.
struct ec_plugin_ops {
  int (*create)(int, int, int);
  void (*destroy)(int);
  int (*encode)(int, const uint8_t*, uint8_t*, size_t);
  int (*decode)(int, const int*, int, const int*, int, const uint8_t*,
                uint8_t*, size_t);
};

static const ec_plugin_ops OPS = {ec_create, ec_destroy, ec_encode, ec_decode};

const ec_plugin_ops* __erasure_code_ops() {
  return initialized ? &OPS : nullptr;
}

}  // extern "C"
