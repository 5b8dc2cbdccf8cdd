// Native host-side data tier of ddpm3d_tpu_torch.
//
// Own copy of the JAX package's host tier, with the same C ABI and code: a
// minimal classic-TIFF reader (little/big endian, uncompressed strips,
// f32/f64/u8/u16/i16/u32/i32 grayscale, multi-page) that returns float32
// and declines compressed, tiled and colour files,
// patch extraction with normalization + zero padding, and Hann-window
// overlap-add blending. All hot loops are simple contiguous scans that
// auto-vectorize.
//
// Exposed with a plain C ABI for ctypes (no pybind11), built by
// ddpm3d_tpu_torch/native/__init__.py with g++ on first use.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <string>
#include <vector>

namespace {

struct Reader {
    FILE* f = nullptr;
    bool big_endian = false;

    ~Reader() { if (f) fclose(f); }

    bool open(const char* path) {
        f = fopen(path, "rb");
        return f != nullptr;
    }
    bool read_at(uint64_t off, void* dst, size_t n) {
        if (fseek(f, (long)off, SEEK_SET) != 0) return false;
        return fread(dst, 1, n, f) == n;
    }
    uint16_t u16(const uint8_t* p) const {
        return big_endian ? (uint16_t)((p[0] << 8) | p[1])
                          : (uint16_t)((p[1] << 8) | p[0]);
    }
    uint32_t u32(const uint8_t* p) const {
        return big_endian
                   ? ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
                         ((uint32_t)p[2] << 8) | p[3]
                   : ((uint32_t)p[3] << 24) | ((uint32_t)p[2] << 16) |
                         ((uint32_t)p[1] << 8) | p[0];
    }
};

struct Page {
    uint32_t width = 0, height = 0, bits = 8, sample_format = 1;
    std::vector<uint64_t> strip_offsets, strip_counts;
    std::string description;
};

constexpr uint16_t TAG_WIDTH = 256, TAG_LENGTH = 257, TAG_BITS = 258,
                   TAG_COMPRESSION = 259, TAG_DESC = 270, TAG_STRIP_OFF = 273,
                   TAG_STRIP_CNT = 279, TAG_FORMAT = 339,
                   TAG_SAMPLES = 277, TAG_TILE_WIDTH = 322;

size_t type_size(uint16_t t) {
    switch (t) {
        case 1: case 2: case 6: case 7: return 1;
        case 3: case 8: return 2;
        case 4: case 9: case 11: return 4;
        case 5: case 10: case 12: return 8;
        default: return 1;
    }
}

bool read_tag_values(Reader& r, uint16_t typ, uint32_t count,
                     const uint8_t* val, std::vector<uint64_t>& out,
                     std::string* str_out) {
    size_t sz = type_size(typ) * count;
    std::vector<uint8_t> buf(sz);
    if (sz <= 4) {
        memcpy(buf.data(), val, sz);
    } else {
        uint64_t off = r.u32(val);
        if (!r.read_at(off, buf.data(), sz)) return false;
    }
    if (typ == 2) {  // ASCII
        if (str_out) str_out->assign((const char*)buf.data(), sz);
        return true;
    }
    out.clear();
    for (uint32_t i = 0; i < count; i++) {
        const uint8_t* p = buf.data() + i * type_size(typ);
        switch (typ) {
            case 1: out.push_back(p[0]); break;
            case 3: out.push_back(r.u16(p)); break;
            case 4: out.push_back(r.u32(p)); break;
            default: return false;
        }
    }
    return true;
}

// Parse all IFDs; returns pages or empty on error.
bool parse_tiff(Reader& r, std::vector<Page>& pages, int* err) {
    uint8_t header[8];
    if (!r.read_at(0, header, 8)) { *err = -2; return false; }
    if (header[0] == 'I' && header[1] == 'I') r.big_endian = false;
    else if (header[0] == 'M' && header[1] == 'M') r.big_endian = true;
    else { *err = -3; return false; }
    if (r.u16(header + 2) != 42) { *err = -3; return false; }
    uint64_t ifd = r.u32(header + 4);

    while (ifd) {
        uint8_t cntb[2];
        if (!r.read_at(ifd, cntb, 2)) { *err = -4; return false; }
        uint16_t n_tags = r.u16(cntb);
        std::vector<uint8_t> entries(n_tags * 12 + 4);
        if (!r.read_at(ifd + 2, entries.data(), entries.size())) {
            *err = -4; return false;
        }
        Page pg;
        for (uint16_t i = 0; i < n_tags; i++) {
            const uint8_t* e = entries.data() + i * 12;
            uint16_t tag = r.u16(e), typ = r.u16(e + 2);
            uint32_t count = r.u32(e + 4);
            const uint8_t* val = e + 8;
            std::vector<uint64_t> vals;
            switch (tag) {
                case TAG_WIDTH:
                    read_tag_values(r, typ, count, val, vals, nullptr);
                    pg.width = (uint32_t)vals[0]; break;
                case TAG_LENGTH:
                    read_tag_values(r, typ, count, val, vals, nullptr);
                    pg.height = (uint32_t)vals[0]; break;
                case TAG_BITS:
                    read_tag_values(r, typ, count, val, vals, nullptr);
                    pg.bits = (uint32_t)vals[0]; break;
                case TAG_COMPRESSION:
                    read_tag_values(r, typ, count, val, vals, nullptr);
                    if (vals[0] != 1) { *err = -5; return false; }
                    break;
                case TAG_FORMAT:
                    read_tag_values(r, typ, count, val, vals, nullptr);
                    pg.sample_format = (uint32_t)vals[0]; break;
                // colour and tiled files are declined: the Python reader
                // takes them (the JAX package's copy misreads both)
                case TAG_SAMPLES:
                    read_tag_values(r, typ, count, val, vals, nullptr);
                    if (vals[0] != 1) { *err = -10; return false; }
                    break;
                case TAG_TILE_WIDTH: *err = -11; return false;
                case TAG_DESC:
                    read_tag_values(r, typ, count, val, vals, &pg.description);
                    break;
                case TAG_STRIP_OFF:
                    read_tag_values(r, typ, count, val, pg.strip_offsets, nullptr);
                    break;
                case TAG_STRIP_CNT:
                    read_tag_values(r, typ, count, val, pg.strip_counts, nullptr);
                    break;
                default: break;
            }
        }
        if (pg.strip_offsets.empty() ||
            pg.strip_offsets.size() != pg.strip_counts.size()) {
            *err = -12; return false;
        }
        pages.push_back(std::move(pg));
        ifd = r.u32(entries.data() + n_tags * 12);
    }
    return true;
}

template <typename T>
void convert_to_f32(const uint8_t* src, float* dst, size_t n, bool swap) {
    const T* s = (const T*)src;
    for (size_t i = 0; i < n; i++) {
        T v = s[i];
        if (swap && sizeof(T) > 1) {
            uint8_t* b = (uint8_t*)&v;
            for (size_t j = 0; j < sizeof(T) / 2; j++) {
                uint8_t t = b[j];
                b[j] = b[sizeof(T) - 1 - j];
                b[sizeof(T) - 1 - j] = t;
            }
        }
        dst[i] = (float)v;
    }
}

}  // namespace

extern "C" {

// Probe a TIFF: fills shape[4] as (C, D, H, W) (C=1/D=1 when absent) and
// returns the number of meaningful leading dims (2, 3, or 4); <0 on error.
int ddpm3d_tiff_shape(const char* path, int64_t* shape) {
    Reader r;
    if (!r.open(path)) return -1;
    std::vector<Page> pages;
    int err = 0;
    if (!parse_tiff(r, pages, &err) || pages.empty()) return err ? err : -6;
    int64_t C = 1, D = (int64_t)pages.size();
    const std::string& d = pages[0].description;
    if (d.find("axes=CDHW") != std::string::npos) {
        size_t cpos = d.find("channels=");
        size_t spos = d.find("slices=");
        if (cpos != std::string::npos) C = atoll(d.c_str() + cpos + 9);
        if (spos != std::string::npos) D = atoll(d.c_str() + spos + 7);
    }
    shape[0] = C;
    shape[1] = D;
    shape[2] = pages[0].height;
    shape[3] = pages[0].width;
    if (C > 1) return 4;
    return D > 1 ? 3 : 2;
}

// Read a TIFF into a caller-allocated float32 buffer (C*D*H*W floats).
// Returns 0 on success.
int ddpm3d_tiff_read_f32(const char* path, float* out, int64_t capacity) {
    Reader r;
    if (!r.open(path)) return -1;
    std::vector<Page> pages;
    int err = 0;
    if (!parse_tiff(r, pages, &err) || pages.empty()) return err ? err : -6;

    int64_t pos = 0;
    std::vector<uint8_t> buf;
    for (const Page& pg : pages) {
        size_t n = (size_t)pg.width * pg.height;
        size_t bytes = n * (pg.bits / 8);
        if (pos + (int64_t)n > capacity) return -7;
        buf.resize(bytes);
        size_t off = 0;
        for (size_t s = 0; s < pg.strip_offsets.size(); s++) {
            size_t cnt = pg.strip_counts[s];
            if (off + cnt > bytes) return -8;
            if (!r.read_at(pg.strip_offsets[s], buf.data() + off, cnt))
                return -8;
            off += cnt;
        }
        float* dst = out + pos;
        bool swap = r.big_endian;  // host assumed little-endian
        if (pg.sample_format == 3 && pg.bits == 32)
            convert_to_f32<float>(buf.data(), dst, n, swap);
        else if (pg.sample_format == 3 && pg.bits == 64)
            convert_to_f32<double>(buf.data(), dst, n, swap);
        else if (pg.bits == 8)
            convert_to_f32<uint8_t>(buf.data(), dst, n, false);
        else if (pg.bits == 16 && pg.sample_format == 2)
            convert_to_f32<int16_t>(buf.data(), dst, n, swap);
        else if (pg.bits == 16)
            convert_to_f32<uint16_t>(buf.data(), dst, n, swap);
        else if (pg.bits == 32 && pg.sample_format == 2)
            convert_to_f32<int32_t>(buf.data(), dst, n, swap);
        else if (pg.bits == 32)
            convert_to_f32<uint32_t>(buf.data(), dst, n, swap);
        else
            return -9;
        pos += (int64_t)n;
    }
    return 0;
}

// Extract n patches of ps^3 from a (Z, X, Y) volume at grid starts
// (x0,y0,z0)*n, scaling by inv_div, zero-padding beyond bounds.
// out layout: [n, ps(z), ps(x), ps(y)].
int ddpm3d_extract_patches(const float* vol, int64_t Z, int64_t X, int64_t Y,
                           const int64_t* grid, int64_t n, int64_t ps,
                           float* out, float inv_div) {
    const int64_t pvox = ps * ps * ps;
    for (int64_t i = 0; i < n; i++) {
        const int64_t x0 = grid[i * 3 + 0];
        const int64_t y0 = grid[i * 3 + 1];
        const int64_t z0 = grid[i * 3 + 2];
        float* dst = out + i * pvox;
        memset(dst, 0, sizeof(float) * pvox);
        const int64_t ze = z0 + ps < Z ? z0 + ps : Z;
        const int64_t xe = x0 + ps < X ? x0 + ps : X;
        const int64_t ye = y0 + ps < Y ? y0 + ps : Y;
        for (int64_t z = z0; z < ze; z++) {
            for (int64_t x = x0; x < xe; x++) {
                const float* src = vol + (z * X + x) * Y + y0;
                float* d = dst + ((z - z0) * ps + (x - x0)) * ps;
                const int64_t len = ye - y0;
                for (int64_t y = 0; y < len; y++) d[y] = src[y] * inv_div;
            }
        }
    }
    return 0;
}

// Hann-window overlap-add of n patches ([n, ps(x), ps(y), ps(z)] layout)
// into acc/weight volumes of shape (X, Y, Z). Caller divides at the end.
int ddpm3d_blend_accumulate(const float* patches, const int64_t* grid,
                            int64_t n, int64_t ps, const float* window,
                            float* acc, float* weight, int64_t X, int64_t Y,
                            int64_t Z) {
    for (int64_t i = 0; i < n; i++) {
        const int64_t x0 = grid[i * 3 + 0];
        const int64_t y0 = grid[i * 3 + 1];
        const int64_t z0 = grid[i * 3 + 2];
        const float* p = patches + i * ps * ps * ps;
        const int64_t xe = x0 + ps < X ? x0 + ps : X;
        const int64_t ye = y0 + ps < Y ? y0 + ps : Y;
        const int64_t ze = z0 + ps < Z ? z0 + ps : Z;
        for (int64_t x = x0; x < xe; x++) {
            for (int64_t y = y0; y < ye; y++) {
                const float* pr = p + ((x - x0) * ps + (y - y0)) * ps;
                const float* wr = window + ((x - x0) * ps + (y - y0)) * ps;
                float* ar = acc + (x * Y + y) * Z + z0;
                float* gr = weight + (x * Y + y) * Z + z0;
                const int64_t len = ze - z0;
                for (int64_t z = 0; z < len; z++) {
                    ar[z] += pr[z] * wr[z];
                    gr[z] += wr[z];
                }
            }
        }
    }
    return 0;
}

// result = acc / weight where weight > 0 else 0
int ddpm3d_blend_finalize(const float* acc, const float* weight, float* out,
                          int64_t n) {
    for (int64_t i = 0; i < n; i++)
        out[i] = weight[i] > 0.0f ? acc[i] / weight[i] : 0.0f;
    return 0;
}

}  // extern "C"
