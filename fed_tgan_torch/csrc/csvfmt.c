/* CSV rows on the host, formatted by several threads without the GIL.
 *
 * The port's analog of the C++ CSV writer the JAX package reaches through
 * pyarrow.  Built with the system C compiler and loaded with ctypes by
 * fed_tgan_torch/data/fastcsv.py, which holds the plain version (Python's
 * csv module) that the tests compare with byte for byte.
 *
 * A table is n rows x c columns.  A column is one of two kinds:
 *
 *   FLOAT: float64 values and an optional blank mask.  A masked cell
 *          writes ' '; any other cell writes the value exactly as Python's
 *          repr(float) does (the shortest string that reads back to the
 *          same double, the nearest one when several are shortest).
 *   TABLE: int32 codes into a table of byte strings, quoted beforehand.
 *
 * Fields are joined with ',' and every row ends in '\n'.  Rows are split
 * into contiguous ranges, one per thread; each thread writes its range into
 * its own region of the caller's buffer and the regions are then moved
 * together in order, so the bytes do not depend on the thread count.
 */

#define _GNU_SOURCE
#include <float.h>
#include <locale.h>
#include <math.h>
#include <pthread.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

enum { KIND_FLOAT = 0, KIND_TABLE = 1 };

/* the longest repr of a float64: sign, 17 digits, '.', 'e', sign, 3 digits */
enum { FLOAT_MAX = 24, MAX_THREADS = 64 };

typedef struct {
    int32_t kind;
    int32_t table_size;    /* TABLE: entries in the table */
    const double *values;  /* FLOAT */
    const uint8_t *blank;  /* FLOAT: 1 = blank cell, or NULL */
    const int32_t *codes;  /* TABLE */
    const char *table;     /* TABLE: the entries back to back */
    const int64_t *offsets;  /* TABLE: table_size + 1 offsets into table */
} fed_tgan_csv_column;

/* ------------------------------------------------------- float64 repr */

/* Parse "%.*e" output ("d", or "d.ddd", then "e+XX"/"e-XX") into digits
 * and the decimal exponent of the first digit. */
static int parse_sci(const char *s, char *digits, int *exp10) {
    int nd = 0;
    for (; *s && *s != 'e'; ++s)
        if (*s != '.') digits[nd++] = *s;
    *exp10 = atoi(s + 1);
    return nd;
}

/* d.ddd...e<exp10> of `nd` digits into buf (for strtod) */
static void sci_string(const char *digits, int nd, int exp10, char *buf) {
    char *p = buf;
    *p++ = digits[0];
    if (nd > 1) {
        *p++ = '.';
        memcpy(p, digits + 1, (size_t)(nd - 1));
        p += nd - 1;
    }
    sprintf(p, "e%d", exp10);
}

/* The digits one unit above (+1) or below (-1) in the last place, with
 * their exponent; the count stays nd (a carry out of 9...9 gives 10...0,
 * a borrow out of 10...0 gives 9...9). */
static void neighbour(const char *digits, int nd, int exp10, int delta,
                      char *out, int *out_exp) {
    memcpy(out, digits, (size_t)nd);
    *out_exp = exp10;
    int i = nd - 1;
    if (delta > 0) {
        while (i >= 0 && out[i] == '9') out[i--] = '0';
        if (i >= 0) {
            out[i]++;
        } else {  /* 9...9 + 1 = 10...0, one place up */
            out[0] = '1';
            memset(out + 1, '0', (size_t)(nd - 1));
            ++*out_exp;
        }
    } else {
        while (i >= 0 && out[i] == '0') out[i--] = '9';
        out[i]--;  /* digits[0] is never '0' */
        if (out[0] == '0') {  /* 10...0 - 1 = 9...9, one place down */
            memset(out, '9', (size_t)nd);
            --*out_exp;
        }
    }
}

/* digits[0:p], or their neighbour one unit above or below in the last
 * place, if it reads back to v: the correctly rounded p-digit decimal
 * need not, where the interval of decimals that read back to v is
 * lopsided (at a power of two), while a neighbour does. */
static int reads_back(double v, char *digits, int p, int *exp10,
                      int neighbours) {
    char buf[48], other[20];
    int e2;
    sci_string(digits, p, *exp10, buf);
    if (strtod(buf, NULL) == v) return 1;
    for (int delta = 1; neighbours && delta >= -1; delta -= 2) {
        neighbour(digits, p, *exp10, delta, other, &e2);
        sci_string(other, p, e2, buf);
        if (strtod(buf, NULL) == v) {
            memcpy(digits, other, (size_t)p);
            *exp10 = e2;
            return 1;
        }
    }
    return 0;
}

/* The correctly rounded p-digit decimal of v > 0, into digits/exp10. */
static void rounded(double v, int p, char *digits, int *exp10) {
    char buf[48];
    snprintf(buf, sizeof buf, "%.*e", p - 1, v);
    parse_sci(buf, digits, exp10);
}

/* ------------------------------------------- exact 128-bit fast path
 *
 * For most doubles the same search runs in exact integer arithmetic:
 * v = m * 2^b (m < 2^53), a p-digit candidate is q * 10^-kk, and both the
 * correctly rounded q and the test "reads back to v" (is within half a
 * gap of v, a tie going to the even m, as strtod rounds) fit in 128 bits
 * when 2^-70 <= 2^b <= 2^70.  Where they do not, it declines and the
 * snprintf/strtod search of shortest() decides. */

typedef unsigned __int128 u128;

static const uint64_t P10[20] = {
    1ull, 10ull, 100ull, 1000ull, 10000ull, 100000ull, 1000000ull,
    10000000ull, 100000000ull, 1000000000ull, 10000000000ull,
    100000000000ull, 1000000000000ull, 10000000000000ull,
    100000000000000ull, 1000000000000000ull, 10000000000000000ull,
    100000000000000000ull, 1000000000000000000ull,
    10000000000000000000ull};

static u128 p10(int k) {  /* 0 <= k <= 38 */
    return k <= 19 ? (u128)P10[k] : (u128)P10[19] * P10[k - 19];
}

/* q = round_half_even(m * 2^b * 10^kk) into *q; 0 where 128 bits do not
 * hold it. */
static int scaled(uint64_t m, int b, int kk, uint64_t *q) {
    u128 num, den;
    if (b < 0) {
        int s = -b;
        if (s > 70 || kk > 22 || kk < -2) return 0;
        num = kk >= 0 ? (u128)m * p10(kk) : (u128)m;
        den = kk >= 0 ? (u128)1 << s : p10(-kk) << s;
    } else {
        if (b > 70 || kk > 1 || kk < -38) return 0;
        num = kk >= 0 ? ((u128)m << b) * p10(kk) : (u128)m << b;
        den = kk >= 0 ? 1 : p10(-kk);
    }
    u128 fl = num / den, rem = num - fl * den;
    if (2 * rem > den || (2 * rem == den && (fl & 1))) ++fl;
    if (fl >> 63) return 0;
    *q = (uint64_t)fl;
    return 1;
}

/* Does q * 10^-kk read back to m * 2^b?  1 yes, 0 no, -1 where 128 bits
 * cannot tell.  The gap below a power of two is half the gap above. */
static int reads_back_exact(uint64_t m, int b, uint64_t q, int kk) {
    u128 nd, nx, unit;  /* candidate, value and gap, scaled alike */
    if (b < 0) {
        int s = -b;
        if (s > 70 || kk > 22 || kk < -2) return -1;
        nd = kk >= 0 ? (u128)q << s : ((u128)q * p10(-kk)) << s;
        nx = kk >= 0 ? (u128)m * p10(kk) : (u128)m;
        unit = kk >= 0 ? p10(kk) : 1;
    } else {
        if (b > 70 || kk > 1 || kk < -19) return -1;
        nd = kk >= 0 ? (u128)q : (u128)q * p10(-kk);
        nx = kk >= 0 ? ((u128)m << b) * p10(kk) : (u128)m << b;
        unit = kk >= 0 ? ((u128)1 << b) * p10(kk) : (u128)1 << b;
    }
    int below = nd < nx;
    u128 diff = below ? nx - nd : nd - nx;
    if (diff >> 120) return 0;
    diff <<= below && m == (1ull << 52) ? 2 : 1;  /* vs half a gap */
    if (diff != unit) return diff < unit;
    return !(m & 1);
}

/* q's decimal digits; their count */
static int u64_digits(uint64_t q, char *digits) {
    char tmp[20];
    int n = 0;
    do {
        tmp[n++] = (char)('0' + q % 10);
        q /= 10;
    } while (q);
    for (int i = 0; i < n; ++i) digits[i] = tmp[n - 1 - i];
    return n;
}

/* The search of shortest() in 128-bit arithmetic; 0 where it declines. */
static int shortest_exact(double v, char *digits, int *exp10) {
    uint64_t bits;
    memcpy(&bits, &v, sizeof bits);
    int biased = (int)(bits >> 52) & 0x7ff;
    if (biased == 0) return 0;  /* subnormal */
    uint64_t m = (bits & ((1ull << 52) - 1)) | (1ull << 52);
    int b = biased - 1075;
    int d = (int)floor(log10(v));  /* the first digit's exponent, +-1 */
    uint64_t q;
    for (int tries = 0;; ++tries) {
        if (tries == 3 || !scaled(m, b, 16 - d, &q)) return 0;
        if (q < P10[16]) --d;
        else if (q >= P10[17]) ++d;
        else break;
    }
    for (int p = 15; p <= 17; ++p) {
        int kk = p - 1 - d;
        if (!scaled(m, b, kk, &q) || q >= P10[p]) return 0;
        int r = reads_back_exact(m, b, q, kk);
        /* the neighbours in the last place, at 16 digits; a borrow into
         * the decade below changes the spacing: left to the slow path */
        for (int delta = 1; r == 0 && p == 16 && delta >= -1; delta -= 2) {
            if (delta < 0 && q - 1 < P10[15]) return 0;
            r = reads_back_exact(m, b, q + delta, kk);
            if (r == 1) q += delta;
        }
        if (r < 0) return 0;
        if (r == 1) {
            int n = u64_digits(q, digits);
            *exp10 = n - 1 - kk;
            while (n > 1 && digits[n - 1] == '0') --n;
            return n;
        }
    }
    return 0;
}

/* The shortest digits that read back to v > 0 (trailing zeros dropped)
 * and the decimal exponent of the first digit. */
static int shortest(double v, char *digits, int *exp10) {
    int p = shortest_exact(v, digits, exp10);
    if (p) return p;
    /* A normal double: any decimal of at most 15 digits survives the trip
     * to the nearest double and back (DBL_DIG), so if a string of <= 15
     * digits reads back to v, the correctly rounded 15-digit string is
     * that string padded with zeros; 17 digits always read back.  A
     * subnormal: fewer digits identify it; search from 1. */
    int normal = v >= DBL_MIN;
    for (int q = normal ? 15 : 1; q <= 17 && !p; ++q) {
        rounded(v, q, digits, exp10);
        if (q == 17 || reads_back(v, digits, q, exp10, !normal || q == 16))
            p = q;
    }
    while (p > 1 && digits[p - 1] == '0') --p;
    return p;
}

/* Python's repr(float) of x into out; returns its length */
static int repr_double(double x, char *out) {
    if (isnan(x)) { memcpy(out, "nan", 3); return 3; }
    char *p = out;
    if (signbit(x)) *p++ = '-';
    if (isinf(x)) { memcpy(p, "inf", 3); return (int)(p - out) + 3; }
    if (x == 0) { memcpy(p, "0.0", 3); return (int)(p - out) + 3; }
    char digits[20];
    int exp10;
    int nd = shortest(fabs(x), digits, &exp10);
    if (exp10 < -4 || exp10 >= 16) {  /* 1.5e-05, 1e+16 */
        *p++ = digits[0];
        if (nd > 1) {
            *p++ = '.';
            memcpy(p, digits + 1, (size_t)(nd - 1));
            p += nd - 1;
        }
        *p++ = 'e';
        *p++ = exp10 < 0 ? '-' : '+';
        int a = exp10 < 0 ? -exp10 : exp10;
        if (a >= 100) *p++ = (char)('0' + a / 100);
        *p++ = (char)('0' + a / 10 % 10);
        *p++ = (char)('0' + a % 10);
    } else if (exp10 < 0) {  /* 0.000123 */
        *p++ = '0';
        *p++ = '.';
        for (int i = -1; i > exp10; --i) *p++ = '0';
        memcpy(p, digits, (size_t)nd);
        p += nd;
    } else {
        int whole = exp10 + 1;  /* digits before the point */
        if (nd > whole) {  /* 12.5 */
            memcpy(p, digits, (size_t)whole);
            p += whole;
            *p++ = '.';
            memcpy(p, digits + whole, (size_t)(nd - whole));
            p += nd - whole;
        } else {  /* 1200.0 */
            memcpy(p, digits, (size_t)nd);
            p += nd;
            for (int i = nd; i < whole; ++i) *p++ = '0';
            *p++ = '.';
            *p++ = '0';
        }
    }
    return (int)(p - out);
}

/* ------------------------------------------------------------- rows */

typedef struct {
    const fed_tgan_csv_column *cols;
    int32_t c;
    int64_t first, last;  /* rows [first, last) */
    char *out;            /* this range's region */
    int64_t written;      /* bytes, or -1 on a code out of range */
} range_job;

static locale_t c_locale;
static pthread_once_t c_locale_once = PTHREAD_ONCE_INIT;

static void make_c_locale(void) {
    c_locale = newlocale(LC_ALL_MASK, "C", (locale_t)0);
}

static void *format_range(void *arg) {
    range_job *job = (range_job *)arg;
    /* snprintf and strtod read the decimal point from the locale */
    locale_t prev = c_locale ? uselocale(c_locale) : (locale_t)0;
    char *p = job->out;
    job->written = -1;
    for (int64_t r = job->first; r < job->last; ++r) {
        for (int32_t j = 0; j < job->c; ++j) {
            const fed_tgan_csv_column *col = &job->cols[j];
            if (col->kind == KIND_FLOAT) {
                if (col->blank && col->blank[r]) *p++ = ' ';
                else p += repr_double(col->values[r], p);
            } else {
                int32_t code = col->codes[r];
                if (code < 0 || code >= col->table_size) goto done;
                int64_t a = col->offsets[code], b = col->offsets[code + 1];
                memcpy(p, col->table + a, (size_t)(b - a));
                p += b - a;
            }
            *p++ = j + 1 < job->c ? ',' : '\n';
        }
    }
    job->written = p - job->out;
done:
    if (prev) uselocale(prev);
    return NULL;
}

/* The most bytes one row can take. */
int64_t fed_tgan_csv_row_bound(const fed_tgan_csv_column *cols, int32_t c) {
    int64_t bound = 0;
    for (int32_t j = 0; j < c; ++j) {
        int64_t widest = FLOAT_MAX;
        if (cols[j].kind == KIND_TABLE) {
            widest = 0;
            for (int32_t t = 0; t < cols[j].table_size; ++t) {
                int64_t w = cols[j].offsets[t + 1] - cols[j].offsets[t];
                if (w > widest) widest = w;
            }
        }
        bound += widest + 1;  /* the cell and its ',' or '\n' */
    }
    return bound;
}

/* Format n rows into out (cap bytes, at least n * row bound) with up to
 * `threads` threads; returns the byte count, -1 when cap is too small, -2
 * when a code lies outside its table. */
int64_t fed_tgan_csv_format(const fed_tgan_csv_column *cols, int32_t c,
                            int64_t n, char *out, int64_t cap,
                            int32_t threads) {
    if (n <= 0 || c <= 0) return 0;
    int64_t bound = fed_tgan_csv_row_bound(cols, c);
    if (cap < n * bound) return -1;
    pthread_once(&c_locale_once, make_c_locale);
    if (threads < 1) threads = 1;
    if (threads > MAX_THREADS) threads = MAX_THREADS;
    if (threads > n) threads = (int32_t)n;
    range_job jobs[MAX_THREADS];
    pthread_t ids[MAX_THREADS];
    int started[MAX_THREADS] = {0};
    for (int32_t t = 0; t < threads; ++t) {
        int64_t first = n * t / threads, last = n * (t + 1) / threads;
        jobs[t] = (range_job){cols, c, first, last, out + first * bound, 0};
    }
    for (int32_t t = 1; t < threads; ++t)
        started[t] = pthread_create(&ids[t], NULL, format_range, &jobs[t]) == 0;
    format_range(&jobs[0]);
    for (int32_t t = 1; t < threads; ++t) {
        if (started[t]) pthread_join(ids[t], NULL);
        else format_range(&jobs[t]);  /* no thread: run it here */
    }
    int64_t total = 0;
    for (int32_t t = 0; t < threads; ++t) {
        if (jobs[t].written < 0) return -2;
        memmove(out + total, jobs[t].out, (size_t)jobs[t].written);
        total += jobs[t].written;
    }
    return total;
}
