// Native FASTA/FASTQ batch parser.
//
// Role parity: the reference reads sequences through needletail (Rust,
// src/core/src/wasm.rs:16-40) / screed (Python, command_sketch.py:318).
// This implementation is original C++ designed for the device sketch pipeline: it
// fills large caller-provided buffers with many records per call
// (contiguous sequence bytes + offset arrays), so Python touches one
// ctypes call per ~8MB batch instead of per record.
//
// Handles plain and gzip input transparently via zlib (gzopen sniffs the
// magic). bzip2 falls back to the Python reader.
//
// Build: g++ -O3 -shared -fPIC fastx.cpp -o libfastx.so -lz

#include <zlib.h>

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

struct Growable {
    char *data = nullptr;
    int64_t len = 0;
    int64_t cap = 0;

    void clear() { len = 0; }

    void reserve(int64_t want) {
        if (want <= cap) return;
        int64_t ncap = cap ? cap : 4096;
        while (ncap < want) ncap *= 2;
        data = static_cast<char *>(realloc(data, ncap));
        cap = ncap;
    }

    void append(const char *src, int64_t n) {
        reserve(len + n);
        memcpy(data + len, src, n);
        len += n;
    }

    ~Growable() { free(data); }
};

constexpr int64_t kChunkSize = 4 << 20;

struct FastxReader {
    gzFile f = nullptr;
    int fmt = 0;  // 0 = unknown yet, 1 = fasta, 2 = fastq
    bool eof = false;
    bool have_pending = false;  // a fully-parsed record waiting to be emitted
    int error = 0;              // sticky parse/IO error code

    Growable line;      // current line buffer
    Growable rec_name;  // pending record name
    Growable rec_seq;   // pending record sequence
    bool line_valid = false;  // `line` holds a peeked line not yet consumed

    // chunked read buffer: lines are scanned with memchr instead of gzgets
    char *chunk = nullptr;
    int64_t chunk_len = 0;
    int64_t chunk_pos = 0;
    bool io_eof = false;

    ~FastxReader() { free(chunk); }
};

bool fill_chunk(FastxReader *r) {
    if (r->io_eof) return false;
    if (!r->chunk) r->chunk = static_cast<char *>(malloc(kChunkSize));
    int got = gzread(r->f, r->chunk, kChunkSize);
    if (got <= 0) {
        r->io_eof = true;
        return false;
    }
    r->chunk_len = got;
    r->chunk_pos = 0;
    return true;
}

// read one full line (without trailing \r\n) into r->line; returns false on EOF
bool read_line(FastxReader *r) {
    if (r->line_valid) return true;  // peeked line already present
    r->line.clear();
    bool got_any = false;
    for (;;) {
        if (r->chunk_pos >= r->chunk_len) {
            if (!fill_chunk(r)) {
                if (!got_any) return false;
                break;  // EOF terminates the final unterminated line
            }
        }
        const char *start = r->chunk + r->chunk_pos;
        int64_t avail = r->chunk_len - r->chunk_pos;
        const char *nl =
            static_cast<const char *>(memchr(start, '\n', avail));
        if (nl) {
            int64_t n = nl - start;
            r->chunk_pos += n + 1;
            if (n > 0 && start[n - 1] == '\r') n--;
            r->line.append(start, n);
            got_any = true;
            break;
        }
        r->line.append(start, avail);
        r->chunk_pos = r->chunk_len;
        got_any = true;
    }
    // a line assembled across chunks may still carry a trailing '\r'
    if (r->line.len > 0 && r->line.data[r->line.len - 1] == '\r') r->line.len--;
    r->line_valid = true;
    return true;
}

void consume_line(FastxReader *r) { r->line_valid = false; }

// peek the first byte of the next line without assembling it; 0 on EOF.
// Leaves chunk_pos at the line start.
char peek_char(FastxReader *r) {
    if (r->line_valid) return r->line.len ? r->line.data[0] : '\n';
    if (r->chunk_pos >= r->chunk_len && !fill_chunk(r)) return 0;
    return r->chunk[r->chunk_pos];
}

// append the next line (sans \r\n) straight into `out`; false on EOF.
// Fast path: the whole line lives inside the current chunk -> one memcpy.
bool append_line_to(FastxReader *r, Growable *out) {
    if (r->line_valid) {  // a peeked assembled line exists; drain it
        out->append(r->line.data, r->line.len);
        r->line_valid = false;
        return true;
    }
    bool got_any = false;
    for (;;) {
        if (r->chunk_pos >= r->chunk_len) {
            if (!fill_chunk(r)) {
                if (got_any) break;
                return false;
            }
        }
        const char *start = r->chunk + r->chunk_pos;
        int64_t avail = r->chunk_len - r->chunk_pos;
        const char *nl = static_cast<const char *>(memchr(start, '\n', avail));
        if (nl) {
            int64_t n = nl - start;
            r->chunk_pos += n + 1;
            if (n > 0 && start[n - 1] == '\r') n--;
            out->append(start, n);
            got_any = true;
            break;
        }
        out->append(start, avail);
        r->chunk_pos = r->chunk_len;
        got_any = true;
    }
    if (out->len > 0 && out->data[out->len - 1] == '\r') out->len--;
    return true;
}

// parse one record into rec_name/rec_seq; 1 = ok, 0 = eof, -1 = malformed
int parse_record(FastxReader *r) {
    if (r->eof) return 0;

    // find the first non-empty line
    for (;;) {
        if (!read_line(r)) {
            r->eof = true;
            return 0;
        }
        if (r->line.len > 0) break;
        consume_line(r);
    }

    char c = r->line.data[0];
    if (r->fmt == 0) {
        if (c == '>')
            r->fmt = 1;
        else if (c == '@')
            r->fmt = 2;
        else
            return -1;
    }

    r->rec_name.clear();
    r->rec_seq.clear();

    if (r->fmt == 1) {
        if (c != '>') return -1;
        r->rec_name.append(r->line.data + 1, r->line.len - 1);
        consume_line(r);
        // sequence lines until next '>' or EOF, appended chunk->record
        for (;;) {
            char p = peek_char(r);
            if (p == 0) {
                r->eof = true;
                break;
            }
            if (p == '>') break;  // next header stays unconsumed
            if (!append_line_to(r, &r->rec_seq)) {
                r->eof = true;
                break;
            }
        }
        return 1;
    }

    // FASTQ: @name / seq / + / qual (4-line records)
    if (c != '@') return -1;
    r->rec_name.append(r->line.data + 1, r->line.len - 1);
    consume_line(r);
    if (!append_line_to(r, &r->rec_seq)) return -1;
    if (!read_line(r)) return -1;
    if (r->line.len == 0 || r->line.data[0] != '+') return -1;
    consume_line(r);
    r->line.clear();
    r->line_valid = false;
    if (!append_line_to(r, &r->line)) return -1;  // quality line, discarded
    r->line.clear();
    return 1;
}

}  // namespace

extern "C" {

void *fastx_open(const char *path) {
    gzFile f = gzopen(path, "rb");
    if (!f) return nullptr;
    gzbuffer(f, 1 << 20);
    auto *r = new FastxReader();
    r->f = f;
    return r;
}

void fastx_close(void *h) {
    auto *r = static_cast<FastxReader *>(h);
    if (r->f) gzclose(r->f);
    delete r;
}

// Fill batch buffers with up to max_records records.
//
// seq_offsets has space for max_records+1 entries (seq_offsets[0] is set to
// 0 by the callee); record i's sequence is seq_buf[seq_offsets[i] :
// seq_offsets[i+1]], likewise names. Returns: number of records (0 = EOF),
// -1 = malformed input, -2 = a single record exceeds the provided buffers
// (caller should grow and retry; the record stays pending).
int64_t fastx_read_batch(void *h, uint8_t *seq_buf, int64_t seq_cap,
                         int64_t *seq_offsets, uint8_t *name_buf,
                         int64_t name_cap, int64_t *name_offsets,
                         int64_t max_records) {
    auto *r = static_cast<FastxReader *>(h);
    int64_t n = 0;
    int64_t seq_used = 0;
    int64_t name_used = 0;
    seq_offsets[0] = 0;
    name_offsets[0] = 0;

    while (n < max_records) {
        if (!r->have_pending) {
            int rc = parse_record(r);
            if (rc == 0) break;
            if (rc < 0) return -1;
            r->have_pending = true;
        }

        if (seq_used + r->rec_seq.len > seq_cap ||
            name_used + r->rec_name.len > name_cap) {
            if (n > 0) break;  // emit what we have; record stays pending
            return -2;         // single record larger than the buffers
        }

        memcpy(seq_buf + seq_used, r->rec_seq.data, r->rec_seq.len);
        seq_used += r->rec_seq.len;
        memcpy(name_buf + name_used, r->rec_name.data, r->rec_name.len);
        name_used += r->rec_name.len;
        n++;
        seq_offsets[n] = seq_used;
        name_offsets[n] = name_used;
        r->have_pending = false;
    }
    return n;
}

}  // extern "C"
