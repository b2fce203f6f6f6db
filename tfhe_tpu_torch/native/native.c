/* Native runtime kernels for tfhe-tpu's host side.
 *
 * The reference delegates its host-native work to Rust (bincode
 * serialization, bit-packed modulus-switched ciphertext storage at
 * ml/extensions/rust/src/compression.rs:59-128, keccak handle hashing via
 * ethers in TS). This C module is the equivalent native layer, loaded via
 * ctypes with a pure-python fallback (tfhe_tpu_torch/native/__init__.py):
 *
 *   - keccak256: Keccak-f[1600] with original (Ethereum) padding, used by
 *     the fhevm handle codec (sdk/relayer/src/sdk/FhevmHandle.ts).
 *   - secp256k1 scalar multiplication (below).
 *
 * The PackedIntegers bit-pack codec lives in numpy in core/seeded.py.
 */

#include <stdint.h>
#include <stddef.h>
#include <string.h>

/* ------------------------------- keccak ------------------------------- */

static const uint64_t RC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808aULL,
    0x8000000080008000ULL, 0x000000000000808bULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008aULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000aULL,
    0x000000008000808bULL, 0x800000000000008bULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800aULL, 0x800000008000000aULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL};

static const int ROTC[24] = {1,  3,  6,  10, 15, 21, 28, 36, 45, 55, 2,  14,
                             27, 41, 56, 8,  25, 43, 62, 18, 39, 61, 20, 44};

static const int PILN[24] = {10, 7,  11, 17, 18, 3, 5,  16, 8,  21, 24, 4,
                             15, 23, 19, 13, 12, 2, 20, 14, 22, 9,  6,  1};

static inline uint64_t rotl64(uint64_t x, int s) {
  return s == 0 ? x : (x << s) | (x >> (64 - s));
}

static void keccak_f1600(uint64_t st[25]) {
  uint64_t bc[5], t;
  for (int round = 0; round < 24; round++) {
    /* theta */
    for (int i = 0; i < 5; i++)
      bc[i] = st[i] ^ st[i + 5] ^ st[i + 10] ^ st[i + 15] ^ st[i + 20];
    for (int i = 0; i < 5; i++) {
      t = bc[(i + 4) % 5] ^ rotl64(bc[(i + 1) % 5], 1);
      for (int j = 0; j < 25; j += 5) st[j + i] ^= t;
    }
    /* rho + pi (tiny-keccak walk) */
    t = st[1];
    for (int i = 0; i < 24; i++) {
      int j = PILN[i];
      bc[0] = st[j];
      st[j] = rotl64(t, ROTC[i]);
      t = bc[0];
    }
    /* chi */
    for (int j = 0; j < 25; j += 5) {
      for (int i = 0; i < 5; i++) bc[i] = st[j + i];
      for (int i = 0; i < 5; i++)
        st[j + i] = bc[i] ^ ((~bc[(i + 1) % 5]) & bc[(i + 2) % 5]);
    }
    /* iota */
    st[0] ^= RC[round];
  }
}

void tfhe_keccak256(const uint8_t *data, size_t len, uint8_t out[32]) {
  uint64_t st[25];
  memset(st, 0, sizeof(st));
  const size_t rate = 136; /* 1088-bit rate */
  while (len >= rate) {
    for (size_t i = 0; i < rate / 8; i++) {
      uint64_t w;
      memcpy(&w, data + 8 * i, 8);
      st[i] ^= w;
    }
    keccak_f1600(st);
    data += rate;
    len -= rate;
  }
  uint8_t block[136];
  memset(block, 0, sizeof(block));
  memcpy(block, data, len);
  block[len] = 0x01; /* original Keccak padding (Ethereum) */
  block[rate - 1] |= 0x80;
  for (size_t i = 0; i < rate / 8; i++) {
    uint64_t w;
    memcpy(&w, block + 8 * i, 8);
    st[i] ^= w;
  }
  keccak_f1600(st);
  memcpy(out, st, 32);
}

/* ---------------------------------------------------------------------------
 * secp256k1 Jacobian scalar multiplication (host-side protocol crypto).
 *
 * The reference verifies coprocessor/KMS EIP-712 signatures with ethers'
 * native secp256k1; the Python implementation in api/secp256k1.py is the
 * semantics oracle and fallback, this is the fast path for the serving
 * loop (sign/recover per quorum member per input). NOT constant-time --
 * acceptable for the dev/test quorums this framework runs in-process
 * (the Python path has the same property, documented there).
 *
 * Field: p = 2^256 - 2^32 - 977. Elements are 4 little-endian u64 limbs,
 * kept canonical (< p). 2^256 == PC (mod p) with PC = 2^32 + 977.
 * ------------------------------------------------------------------------- */

typedef unsigned __int128 u128;

static const uint64_t EC_P[4] = {
    0xFFFFFFFEFFFFFC2FULL, 0xFFFFFFFFFFFFFFFFULL,
    0xFFFFFFFFFFFFFFFFULL, 0xFFFFFFFFFFFFFFFFULL};
#define EC_PC 0x1000003D1ULL /* 2^256 mod p */

static int fe_cmp(const uint64_t a[4], const uint64_t b[4]) {
  for (int i = 3; i >= 0; i--) {
    if (a[i] < b[i]) return -1;
    if (a[i] > b[i]) return 1;
  }
  return 0;
}

static int fe_is_zero(const uint64_t a[4]) {
  return (a[0] | a[1] | a[2] | a[3]) == 0;
}

/* r = a - b, assuming a >= b */
static void fe_sub_nob(uint64_t r[4], const uint64_t a[4], const uint64_t b[4]) {
  u128 borrow = 0;
  for (int i = 0; i < 4; i++) {
    u128 t = (u128)a[i] - b[i] - (uint64_t)borrow;
    r[i] = (uint64_t)t;
    borrow = (t >> 64) & 1;
  }
}

static void fe_add(uint64_t r[4], const uint64_t a[4], const uint64_t b[4]) {
  u128 c = 0;
  uint64_t t[4];
  for (int i = 0; i < 4; i++) {
    c += (u128)a[i] + b[i];
    t[i] = (uint64_t)c;
    c >>= 64;
  }
  if (c) { /* value = t + 2^256; subtract p by adding PC (no carry: t < p) */
    u128 c2 = (u128)t[0] + EC_PC;
    t[0] = (uint64_t)c2;
    for (int i = 1; i < 4; i++) {
      c2 = (c2 >> 64) + t[i];
      t[i] = (uint64_t)c2;
    }
  } else if (fe_cmp(t, EC_P) >= 0) {
    fe_sub_nob(t, t, EC_P);
  }
  r[0] = t[0]; r[1] = t[1]; r[2] = t[2]; r[3] = t[3];
}

static void fe_sub(uint64_t r[4], const uint64_t a[4], const uint64_t b[4]) {
  if (fe_cmp(a, b) >= 0) {
    fe_sub_nob(r, a, b);
  } else {
    uint64_t t[4];
    fe_sub_nob(t, EC_P, b);
    fe_add(r, a, t); /* a + (p - b), both < p */
  }
}

static void fe_mul(uint64_t r[4], const uint64_t a[4], const uint64_t b[4]) {
  uint64_t lo[4], hi[4];
  u128 acc = 0;
  uint64_t prod[8] = {0};
  /* schoolbook 4x4 */
  for (int k = 0; k < 7; k++) {
    u128 carry = 0;
    for (int i = (k < 4 ? 0 : k - 3); i <= (k < 4 ? k : 3); i++) {
      u128 t = (u128)a[i] * b[k - i];
      acc += (uint64_t)t;
      carry += (uint64_t)(t >> 64);
    }
    prod[k] = (uint64_t)acc;
    acc = (acc >> 64) + carry;
  }
  prod[7] = (uint64_t)acc;
  for (int i = 0; i < 4; i++) { lo[i] = prod[i]; hi[i] = prod[i + 4]; }
  /* fold: value = lo + hi * PC  (hi*PC < 2^290) */
  uint64_t m[5];
  u128 c = 0;
  for (int i = 0; i < 4; i++) {
    c += (u128)hi[i] * EC_PC + lo[i];
    m[i] = (uint64_t)c;
    c >>= 64;
  }
  m[4] = (uint64_t)c; /* < 2^34 */
  /* fold again: m[4] * PC into the low limbs */
  c = (u128)m[4] * EC_PC + m[0];
  uint64_t t[4];
  t[0] = (uint64_t)c;
  c >>= 64;
  for (int i = 1; i < 4; i++) {
    c += m[i];
    t[i] = (uint64_t)c;
    c >>= 64;
  }
  if (c) { /* one last carry: add PC once (t < p afterwards) */
    u128 c2 = (u128)t[0] + EC_PC;
    t[0] = (uint64_t)c2;
    for (int i = 1; i < 4; i++) {
      c2 = (c2 >> 64) + t[i];
      t[i] = (uint64_t)c2;
    }
  }
  while (fe_cmp(t, EC_P) >= 0) fe_sub_nob(t, t, EC_P);
  r[0] = t[0]; r[1] = t[1]; r[2] = t[2]; r[3] = t[3];
}

static void fe_sqr(uint64_t r[4], const uint64_t a[4]) { fe_mul(r, a, a); }

static void fe_inv(uint64_t r[4], const uint64_t a[4]) {
  /* Fermat: a^(p-2) by square-and-multiply over the fixed exponent */
  uint64_t e[4];
  fe_sub_nob(e, EC_P, (const uint64_t[4]){2, 0, 0, 0});
  uint64_t acc[4] = {1, 0, 0, 0}, base[4];
  memcpy(base, a, 32);
  for (int i = 0; i < 256; i++) {
    if ((e[i >> 6] >> (i & 63)) & 1) fe_mul(acc, acc, base);
    fe_sqr(base, base);
  }
  memcpy(r, acc, 32);
}

/* Jacobian point: x, y, z (z == 0 encodes infinity) */
typedef struct { uint64_t x[4], y[4], z[4]; } ecpt;

static void pt_dbl(ecpt *o, const ecpt *p) {
  if (fe_is_zero(p->z) || fe_is_zero(p->y)) {
    memset(o, 0, sizeof(*o));
    o->y[0] = 1;
    return;
  }
  uint64_t y2[4], s[4], m[4], t[4], x2[4], y4[4];
  fe_sqr(y2, p->y);
  fe_mul(s, p->x, y2);
  fe_add(s, s, s); fe_add(s, s, s);            /* s = 4xy^2 */
  fe_sqr(m, p->x); fe_add(t, m, m); fe_add(m, t, m); /* m = 3x^2 */
  fe_sqr(x2, m);
  fe_add(t, s, s);
  fe_sub(x2, x2, t);                            /* x' = m^2 - 2s */
  fe_sqr(y4, y2);                               /* y^4 */
  fe_add(y4, y4, y4); fe_add(y4, y4, y4); fe_add(y4, y4, y4); /* 8y^4 */
  fe_sub(t, s, x2);
  fe_mul(t, m, t);
  fe_sub(t, t, y4);                             /* y' = m(s-x') - 8y^4 */
  uint64_t z2[4];
  fe_mul(z2, p->y, p->z);
  fe_add(z2, z2, z2);                           /* z' = 2yz */
  memcpy(o->x, x2, 32); memcpy(o->y, t, 32); memcpy(o->z, z2, 32);
}

static void pt_add(ecpt *o, const ecpt *p, const ecpt *q) {
  if (fe_is_zero(p->z)) { *o = *q; return; }
  if (fe_is_zero(q->z)) { *o = *p; return; }
  uint64_t zz1[4], zz2[4], u1[4], u2[4], s1[4], s2[4];
  fe_sqr(zz1, p->z); fe_sqr(zz2, q->z);
  fe_mul(u1, p->x, zz2); fe_mul(u2, q->x, zz1);
  fe_mul(s1, p->y, zz2); fe_mul(s1, s1, q->z);
  fe_mul(s2, q->y, zz1); fe_mul(s2, s2, p->z);
  if (fe_cmp(u1, u2) == 0) {
    if (fe_cmp(s1, s2) != 0) {
      memset(o, 0, sizeof(*o));
      o->y[0] = 1;
      return;
    }
    pt_dbl(o, p);
    return;
  }
  uint64_t h[4], rr[4], hh[4], hhh[4], v[4], t[4];
  fe_sub(h, u2, u1);
  fe_sub(rr, s2, s1);
  fe_sqr(hh, h);
  fe_mul(hhh, hh, h);
  fe_mul(v, u1, hh);
  fe_sqr(t, rr);
  fe_sub(t, t, hhh);
  uint64_t v2[4];
  fe_add(v2, v, v);
  fe_sub(t, t, v2);                             /* x3 */
  uint64_t y3[4];
  fe_sub(y3, v, t);
  fe_mul(y3, rr, y3);
  uint64_t s1h[4];
  fe_mul(s1h, s1, hhh);
  fe_sub(y3, y3, s1h);                          /* y3 */
  uint64_t z3[4];
  fe_mul(z3, h, p->z);
  fe_mul(z3, z3, q->z);
  memcpy(o->x, t, 32); memcpy(o->y, y3, 32); memcpy(o->z, z3, 32);
}

static int scalar_bits(const uint64_t k[4]) {
  for (int i = 3; i >= 0; i--)
    if (k[i]) {
      int b = 63;
      while (!((k[i] >> b) & 1)) b--;
      return i * 64 + b + 1;
    }
  return 0;
}

/* out = k * P. in/out: x,y,z as 12 consecutive u64 limbs. */
void tfhe_ec_mul(const uint64_t *pt, const uint64_t *k, uint64_t *out) {
  ecpt p, acc;
  memcpy(&p, pt, 96);
  memset(&acc, 0, sizeof(acc));
  acc.y[0] = 1;
  int nb = scalar_bits(k);
  for (int i = nb - 1; i >= 0; i--) {
    pt_dbl(&acc, &acc);
    if ((k[i >> 6] >> (i & 63)) & 1) pt_add(&acc, &acc, &p);
  }
  memcpy(out, &acc, 96);
}

/* out = ka * A + kb * B (Strauss-Shamir shared-doubling ladder). */
void tfhe_ec_mul2(const uint64_t *a, const uint64_t *ka, const uint64_t *b,
                  const uint64_t *kb, uint64_t *out) {
  ecpt pa, pb, both, acc;
  memcpy(&pa, a, 96);
  memcpy(&pb, b, 96);
  pt_add(&both, &pa, &pb);
  memset(&acc, 0, sizeof(acc));
  acc.y[0] = 1;
  int na = scalar_bits(ka), nbb = scalar_bits(kb);
  int nb = na > nbb ? na : nbb;
  for (int i = nb - 1; i >= 0; i--) {
    pt_dbl(&acc, &acc);
    int b1 = (ka[i >> 6] >> (i & 63)) & 1;
    int b2 = (kb[i >> 6] >> (i & 63)) & 1;
    if (b1 && b2) pt_add(&acc, &acc, &both);
    else if (b1) pt_add(&acc, &acc, &pa);
    else if (b2) pt_add(&acc, &acc, &pb);
  }
  memcpy(out, &acc, 96);
}

/* affine conversion: out_xy = (x/z^2, y/z^3); returns 0 at infinity */
int tfhe_ec_affine(const uint64_t *pt, uint64_t *out_xy) {
  ecpt p;
  memcpy(&p, pt, 96);
  if (fe_is_zero(p.z)) return 0;
  uint64_t zi[4], zi2[4], zi3[4];
  fe_inv(zi, p.z);
  fe_sqr(zi2, zi);
  fe_mul(zi3, zi2, zi);
  fe_mul(out_xy, p.x, zi2);
  fe_mul(out_xy + 4, p.y, zi3);
  return 1;
}
