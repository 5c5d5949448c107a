// Native HTTP front-end for the caption service.
//
// Motivation (benchmarks/bench_serve_http.py): every request on the
// pure-Python server pays ~0.25 ms of Python under the GIL (HTTP parse,
// future, queue hop, thread wakeup); at 512 concurrent HTTP clients it
// serves 1,139 captions/s at p50 364 ms vs 1,621-1,770/s at p50 ~220 ms
// through this front-end.
// Here C++ owns the per-REQUEST work — accept, HTTP/1.1 parsing, the
// id-request JSON, queueing, response framing — and Python enters once
// per coalesced BATCH: it pulls up to max_n (id, request) pairs, runs the
// batched on-device beam search, and pushes caption strings back.
//
// Scope: the full /v1/caption request surface —
//   POST /v1/caption  {"id": N} | {"ids": [N, ...]}   (integers only)
//   POST /v1/caption  {"features": [[f, ...], ...]}   raw fc7 rows
//                     (enabled once the pump registers the feature dim
//                     via lrcn_serve_set_feature_dim; rows are parsed
//                     in C++ and travel the queue as float payloads)
//   POST /v1/caption  {"image_b64": "..."} | {"images_b64": [...]}
//                     (enabled via lrcn_serve_set_image_support; bytes
//                     are base64-decoded in C++ and travel a separate
//                     blob queue to the pump's image thread, which
//                     feeds the service's VGG encode stage)
//   GET  /healthz, GET /stats                         (answered in C++)
// With neither capability registered (pre-round-4 pumps), feature and
// image bodies return 501 pointing at the Python server (lrcn serve
// without --native-frontend), which shares the same request surface.
//
// Threading: one acceptor + a fixed pool of connection threads (blocking
// reads, HTTP keep-alive). A connection thread parses a request, enqueues
// its items (bounded queue -> immediate 503 on overflow), and sleeps on
// the request's condvar until the Python pump fills every slot; it then
// writes the JSON response and loops for the next request.

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <array>
#include <atomic>
#include <cctype>
#include <chrono>
#include <condition_variable>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct Request {
    long long serial = 0;
    std::vector<long long> ids;
    std::vector<std::string> captions;   // filled by the pump
    size_t filled = 0;
    int error_status = 0;                // != 0: respond with an error
    std::string error_msg;
    std::mutex mu;
    std::condition_variable cv;
    bool done() const { return error_status != 0 || filled == ids.size(); }
};

struct Item {
    // Holds the request SERIAL, never a Request* — a queued item can
    // outlive its request (the connection thread responds 504 on
    // timeout and destroys the stack-allocated Request while not-yet-
    // pulled items are still in the queue).  The pump resolves serials
    // through the live map, which is purged before destruction.
    long long id;
    long long serial;
    size_t slot;
    // Raw-feature requests: one fc7 row (feat_dim floats), owned by the
    // item itself (shared_ptr, NOT a pointer into the Request — same
    // lifetime rule as the serial above).  Null for id items.  Worst
    // case memory: max_queue * feat_dim * 4 B (64 MB at 4096 x 4096).
    std::shared_ptr<std::vector<float>> feat;
    // Base64-image requests: the DECODED image bytes (JPEG/PNG), same
    // ownership rule.  Blob items live in Server::blobq, not the main
    // queue (variable-size payloads pull one at a time).
    std::shared_ptr<std::string> blob;
};

struct Server {
    int listen_fd = -1;
    int port = 0;
    std::atomic<bool> stopping{false};
    std::thread acceptor;

    std::mutex qmu;
    std::condition_variable qcv;
    std::deque<Item> queue;
    size_t max_queue = 4096;

    // image blobs: separate queue + condvar (the flat pull must not
    // skip-and-reorder variable-size items); bounded by max_blobq
    std::mutex bmu;
    std::condition_variable bcv;
    std::deque<Item> blobq;
    size_t max_blobq = 64;

    std::mutex live_mu;                       // serials -> live requests
    std::unordered_map<long long, Request*> live;
    std::atomic<long long> next_serial{1};

    // stats
    std::atomic<long long> requests{0}, items{0}, batches{0}, shed{0},
        errors{0}, feat_items{0}, img_items{0};

    int request_timeout_ms = 60000;   // condvar wait bound -> 504

    // fc7 row width for {"features": [[...], ...]} bodies; 0 (unset)
    // keeps the pre-round-4 behavior (501 -> the Python server)
    std::atomic<int> feat_dim{0};
    // image_b64 bodies accepted once the pump registers an encoder
    std::atomic<bool> images_ok{false};

    // token id -> word, registered once by the pump (set_vocab) so
    // responses can be built from RAW device tokens without Python
    // detokenization on the hot path
    std::vector<std::string> vocab;

    // image id -> feature-store row, registered once by the pump when
    // the service has an HBM-resident table (set_id_rows).  Connection
    // threads resolve ids (and 400 unknown ones) at PARSE time, fully
    // parallel — the pump's Python never touches per-item row
    // resolution again (it was 62% of a core at the r4 knee).  Null =
    // unregistered: raw ids pass through and the pump resolves.
    std::shared_ptr<const std::unordered_map<long long, long long>>
        id_rows;
    std::mutex id_rows_mu;

    // set by lrcn_serve_ready() once the Python side has registered
    // the vocab + id->row map and started the pump.  The listener is
    // live from lrcn_serve_start (the port is bound and /healthz
    // answers), but a caption request accepted BEFORE set_id_rows
    // would enqueue a RAW image id the pump would treat as a store
    // row — a wrong-caption bug, not a latency blip.  Until ready,
    // /v1/caption answers 503 "warming up".
    std::atomic<bool> ready{false};
};

bool server_stopping(const Server* sv) { return sv->stopping.load(); }

// `deadline` (optional) bounds the WHOLE line read: between requests a
// pooled client may idle indefinitely (no deadline), but once a request
// has started, header lines must keep arriving — otherwise a slowloris
// client trickling one header byte per poll interval pins this
// connection thread forever and exhausts the thread limit.
bool read_line(const Server* sv, int fd, std::string& line,
               std::string& buf,
               const std::chrono::steady_clock::time_point* deadline
                   = nullptr) {
    for (;;) {
        size_t nl = buf.find("\r\n");
        if (nl != std::string::npos) {
            line = buf.substr(0, nl);
            buf.erase(0, nl + 2);
            return true;
        }
        char tmp[4096];
        // check BEFORE blocking again: a client trickling bytes inside
        // each SO_RCVTIMEO window never hits the n<0 branch, so the
        // deadline must also bound successful-read progress
        if (deadline != nullptr &&
            std::chrono::steady_clock::now() >= *deadline)
            return false;
        ssize_t n = ::recv(fd, tmp, sizeof tmp, 0);
        if (n == 0) return false;                     // peer closed
        if (n < 0) {
            // SO_RCVTIMEO expiry: idle keep-alive wakeup — re-check the
            // stopping flag (and the request deadline, if any) and keep
            // waiting (a pooled client may idle far longer than the 5s
            // poll interval)
            if ((errno == EAGAIN || errno == EWOULDBLOCK ||
                 errno == EINTR) && !server_stopping(sv) &&
                (deadline == nullptr ||
                 std::chrono::steady_clock::now() < *deadline))
                continue;
            return false;
        }
        buf.append(tmp, n);
        if (buf.size() > (64u << 20)) return false;   // header bomb
    }
}

void send_all(int fd, const std::string& s) {
    size_t off = 0;
    while (off < s.size()) {
        ssize_t n = ::send(fd, s.data() + off, s.size() - off, MSG_NOSIGNAL);
        if (n <= 0) return;
        off += n;
    }
}

void respond(int fd, int status, const std::string& body,
             bool keep_alive) {
    const char* reason = status == 200 ? "OK"
                       : status == 400 ? "Bad Request"
                       : status == 404 ? "Not Found"
                       : status == 501 ? "Not Implemented"
                       : status == 503 ? "Service Unavailable"
                       : status == 413 ? "Payload Too Large"
                       : "Error";
    std::string head = "HTTP/1.1 " + std::to_string(status) + " " +
        reason + "\r\nContent-Type: application/json\r\nContent-Length: " +
        std::to_string(body.size()) +
        (keep_alive ? "\r\nConnection: keep-alive"
                    : "\r\nConnection: close") + "\r\n\r\n";
    send_all(fd, head + body);
}

std::string json_escape(const std::string& s) {
    std::string out;
    out.reserve(s.size() + 2);
    for (char c : s) {
        if (c == '"' || c == '\\') { out += '\\'; out += c; }
        else if ((unsigned char)c < 0x20) { out += ' '; }
        else out += c;
    }
    return out;
}

// strict parse of {"id": N} / {"ids": [N, ...]} — integers only.
// returns false on anything else (caller responds 501/400).
bool parse_ids(const std::string& body, std::vector<long long>& ids,
               bool& unsupported) {
    unsupported = false;
    size_t i = 0;
    auto skip_ws = [&] { while (i < body.size() &&
        (body[i] == ' ' || body[i] == '\t' || body[i] == '\n' ||
         body[i] == '\r')) i++; };
    auto parse_int = [&](long long& v) -> bool {
        skip_ws();
        bool neg = false;
        if (i < body.size() && (body[i] == '-' || body[i] == '+')) {
            neg = body[i] == '-';
            i++;
        }
        size_t digits = 0;
        v = 0;
        while (i < body.size() && isdigit((unsigned char)body[i])) {
            if (++digits > 18) return false;    // overflow-safe bound
            v = v * 10 + (body[i] - '0');
            i++;
        }
        if (digits == 0) return false;          // bare sign / no number
        if (neg) v = -v;
        return true;
    };
    skip_ws();
    if (i >= body.size() || body[i] != '{') return false;
    i++;
    skip_ws();
    if (body.compare(i, 4, "\"id\"") == 0) {
        i += 4;
        skip_ws();
        if (i >= body.size() || body[i] != ':') return false;
        i++;
        long long v;
        if (!parse_int(v)) return false;
        ids.push_back(v);
    } else if (body.compare(i, 5, "\"ids\"") == 0) {
        i += 5;
        skip_ws();
        if (i >= body.size() || body[i] != ':') return false;
        i++;
        skip_ws();
        if (i >= body.size() || body[i] != '[') return false;
        i++;
        skip_ws();
        if (i < body.size() && body[i] == ']') { i++; }
        else for (;;) {
            long long v;
            if (!parse_int(v)) return false;
            ids.push_back(v);
            skip_ws();
            if (i < body.size() && body[i] == ',') { i++; continue; }
            if (i < body.size() && body[i] == ']') { i++; break; }
            return false;
        }
    } else {
        // a well-formed body for the Python server (features/images)?
        unsupported = body.find("\"features\"") != std::string::npos ||
                      body.find("_b64\"") != std::string::npos;
        return false;
    }
    skip_ws();
    if (i >= body.size() || body[i] != '}') return false;
    return true;
}

// strict parse of {"features": [[f, ...], ...]} — rows of exactly `dim`
// JSON numbers (strtod grammar).  On failure fills `err` and returns
// false (caller responds 400).  Exception-free like parse_ids: this
// runs in a detached connection thread.
bool parse_features(const std::string& body,
                    std::vector<std::shared_ptr<std::vector<float>>>& rows,
                    int dim, std::string& err) {
    size_t i = 0;
    auto skip_ws = [&] { while (i < body.size() &&
        (body[i] == ' ' || body[i] == '\t' || body[i] == '\n' ||
         body[i] == '\r')) i++; };
    skip_ws();
    if (i >= body.size() || body[i] != '{') { err = "not an object";
                                              return false; }
    i++;
    skip_ws();
    if (body.compare(i, 10, "\"features\"") != 0) {
        err = "body needs features";
        return false;
    }
    i += 10;
    skip_ws();
    if (i >= body.size() || body[i] != ':') { err = "bad features";
                                              return false; }
    i++;
    skip_ws();
    if (i >= body.size() || body[i] != '[') {
        err = "features must be a list of rows";
        return false;
    }
    i++;
    skip_ws();
    if (i < body.size() && body[i] == ']') { i++; }
    else for (;;) {                                   // one row per loop
        skip_ws();
        if (i >= body.size() || body[i] != '[') {
            err = "features must be a list of rows (lists of numbers)";
            return false;
        }
        i++;
        auto row = std::make_shared<std::vector<float>>();
        row->reserve((size_t)dim);
        skip_ws();
        if (i < body.size() && body[i] == ']') { i++; }
        else for (;;) {                               // one number
            skip_ws();
            // strtod is safe here: body.c_str() is NUL-terminated, so
            // the scan cannot run past the buffer
            const char* start = body.c_str() + i;
            char* end = nullptr;
            double v = std::strtod(start, &end);
            if (end == start) { err = "bad number in features row";
                                return false; }
            i += (size_t)(end - start);
            if ((int)row->size() >= dim) {
                err = "feature row has more than " +
                      std::to_string(dim) + " dims";
                return false;
            }
            row->push_back((float)v);
            skip_ws();
            if (i < body.size() && body[i] == ',') { i++; continue; }
            if (i < body.size() && body[i] == ']') { i++; break; }
            err = "bad features row";
            return false;
        }
        if ((int)row->size() != dim) {
            err = "feature row has " + std::to_string(row->size()) +
                  " dims, model expects " + std::to_string(dim);
            return false;
        }
        rows.push_back(std::move(row));
        skip_ws();
        if (i < body.size() && body[i] == ',') { i++; continue; }
        if (i < body.size() && body[i] == ']') { i++; break; }
        err = "bad features list";
        return false;
    }
    skip_ws();
    if (i >= body.size() || body[i] != '}') { err = "trailing content";
                                              return false; }
    i++;
    skip_ws();
    if (i != body.size()) { err = "trailing content"; return false; }
    return rows.size() > 0 || (err = "features is empty", false);
}

// standard-alphabet base64 -> bytes; false on any character outside
// [A-Za-z0-9+/=] or bad padding ('=' only at the end).  Base64 text
// never contains '"' or '\\', so a JSON string holding it needs no
// escape handling — any escape is simply an invalid character here.
bool b64_decode(const char* s, size_t len, std::string& out) {
    // C++11 guarantees thread-safe one-time init of this local static
    static const std::array<signed char, 256> table = [] {
        std::array<signed char, 256> t;
        t.fill(-1);
        const char* a = "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
                        "abcdefghijklmnopqrstuvwxyz0123456789+/";
        for (int j = 0; a[j]; j++) t[(unsigned char)a[j]] =
            (signed char)j;
        return t;
    }();
    while (len && s[len - 1] == '=') len--;     // strip padding
    out.clear();
    out.reserve(len * 3 / 4);
    unsigned acc = 0;
    int bits = 0;
    for (size_t j = 0; j < len; j++) {
        signed char v = table[(unsigned char)s[j]];
        if (v < 0) return false;                // incl. '=' mid-stream
        acc = (acc << 6) | (unsigned)v;
        bits += 6;
        if (bits >= 8) {
            bits -= 8;
            out.push_back((char)((acc >> bits) & 0xff));
        }
    }
    return bits < 6;   // a single leftover sextet is invalid base64
}

// strict parse of {"image_b64": "..."} / {"images_b64": ["...", ...]};
// decodes each string to bytes.  Exception-free (detached thread).
bool parse_images(const std::string& body,
                  std::vector<std::shared_ptr<std::string>>& blobs,
                  std::string& err) {
    size_t i = 0;
    auto skip_ws = [&] { while (i < body.size() &&
        (body[i] == ' ' || body[i] == '\t' || body[i] == '\n' ||
         body[i] == '\r')) i++; };
    auto parse_one = [&]() -> bool {
        skip_ws();
        if (i >= body.size() || body[i] != '"') {
            err = "image must be a base64 string";
            return false;
        }
        i++;
        size_t end = body.find('"', i);
        if (end == std::string::npos) { err = "unterminated string";
                                        return false; }
        auto blob = std::make_shared<std::string>();
        if (!b64_decode(body.c_str() + i, end - i, *blob)) {
            err = "invalid base64";
            return false;
        }
        if (blob->empty()) { err = "empty image"; return false; }
        blobs.push_back(std::move(blob));
        i = end + 1;
        return true;
    };
    skip_ws();
    if (i >= body.size() || body[i] != '{') { err = "not an object";
                                              return false; }
    i++;
    skip_ws();
    if (body.compare(i, 11, "\"image_b64\"") == 0) {
        i += 11;
        skip_ws();
        if (i >= body.size() || body[i] != ':') { err = "bad image_b64";
                                                  return false; }
        i++;
        if (!parse_one()) return false;
    } else if (body.compare(i, 12, "\"images_b64\"") == 0) {
        i += 12;
        skip_ws();
        if (i >= body.size() || body[i] != ':') { err = "bad images_b64";
                                                  return false; }
        i++;
        skip_ws();
        if (i >= body.size() || body[i] != '[') {
            err = "images_b64 must be a list";
            return false;
        }
        i++;
        skip_ws();
        if (i < body.size() && body[i] == ']') { i++; }
        else for (;;) {
            if (!parse_one()) return false;
            skip_ws();
            if (i < body.size() && body[i] == ',') { i++; continue; }
            if (i < body.size() && body[i] == ']') { i++; break; }
            err = "bad images_b64 list";
            return false;
        }
    } else {
        err = "body needs image_b64 or images_b64";
        return false;
    }
    skip_ws();
    if (i >= body.size() || body[i] != '}') { err = "trailing content";
                                              return false; }
    i++;
    skip_ws();
    if (i != body.size()) { err = "trailing content"; return false; }
    return blobs.size() > 0 || (err = "no images", false);
}

void handle_connection(Server* sv, int fd) {
    // bounded reads: idle keep-alive connections wake periodically and
    // re-check the stopping flag instead of blocking in recv forever
    timeval tv{5, 0};
    ::setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof tv);
    std::string buf;
    while (!sv->stopping.load()) {
        std::string reqline;
        if (!read_line(sv, fd, reqline, buf)) break;
        if (reqline.empty()) continue;
        // a request has started: header lines are bounded by the
        // request timeout (slow-header slowloris defense; the body loop
        // below has the same bound)
        auto hdr_deadline = std::chrono::steady_clock::now() +
            std::chrono::milliseconds(sv->request_timeout_ms);
        // headers (exception-free parsing: an uncaught throw in this
        // detached thread would std::terminate the whole process)
        size_t content_length = 0;
        bool keep_alive = true;
        bool bad_headers = false, chunked = false;
        for (;;) {
            std::string h;
            if (!read_line(sv, fd, h, buf, &hdr_deadline)) {
                ::close(fd);
                return;
            }
            if (h.empty()) break;
            for (auto& c : h) c = tolower(c);
            if (h.rfind("content-length:", 0) == 0) {
                content_length = 0;
                size_t digits = 0, j = 15;
                while (j < h.size() && (h[j] == ' ' || h[j] == '\t')) j++;
                while (j < h.size() && isdigit((unsigned char)h[j])) {
                    if (++digits > 12) { bad_headers = true; break; }
                    content_length = content_length * 10 + (h[j] - '0');
                    j++;
                }
                while (j < h.size() && (h[j] == ' ' || h[j] == '\t' ||
                                        h[j] == '\r')) j++;
                if (digits == 0 || j != h.size()) bad_headers = true;
            }
            if (h.rfind("transfer-encoding:", 0) == 0 &&
                h.find("chunked") != std::string::npos)
                chunked = true;
            if (h.rfind("connection:", 0) == 0 &&
                h.find("close") != std::string::npos)
                keep_alive = false;
        }
        if (bad_headers) {
            respond(fd, 400, "{\"error\": \"bad content-length\"}", false);
            break;
        }
        if (chunked) {   // not implemented; closing avoids stream desync
            respond(fd, 501,
                    "{\"error\": \"chunked bodies not supported\"}",
                    false);
            break;
        }
        if (content_length > (64u << 20)) {
            respond(fd, 413, "{\"error\": \"body too large\"}", false);
            break;
        }
        auto body_deadline = std::chrono::steady_clock::now() +
            std::chrono::milliseconds(sv->request_timeout_ms);
        while (buf.size() < content_length) {
            char tmp[65536];
            // bound trickled uploads too (see read_line): progress that
            // never trips SO_RCVTIMEO must still respect the deadline
            if (std::chrono::steady_clock::now() >= body_deadline) {
                ::close(fd);
                return;
            }
            ssize_t n = ::recv(fd, tmp, sizeof tmp, 0);
            if (n == 0) { ::close(fd); return; }
            if (n < 0) {
                // SO_RCVTIMEO expiry mid-body: a slow-but-legitimate
                // client (trickled upload) keeps the connection across
                // per-read timeouts, but the WHOLE body is bounded by
                // the request timeout — a silent client can't pin a
                // connection thread forever
                if ((errno == EAGAIN || errno == EWOULDBLOCK ||
                     errno == EINTR) && !sv->stopping.load() &&
                    std::chrono::steady_clock::now() < body_deadline)
                    continue;
                ::close(fd);
                return;
            }
            buf.append(tmp, n);
        }
        std::string body = buf.substr(0, content_length);
        buf.erase(0, content_length);

        if (reqline.rfind("GET /healthz", 0) == 0) {
            respond(fd, 200, std::string("{\"ok\": true, \"ready\": ") +
                    (sv->ready.load() ? "true" : "false") +
                    ", \"frontend\": \"native\"}", keep_alive);
            continue;
        }
        if (reqline.rfind("GET /stats", 0) == 0) {
            long long b = sv->batches.load(), it = sv->items.load();
            size_t qd;
            {
                std::lock_guard<std::mutex> qlk(sv->qmu);
                qd = sv->queue.size();
            }
            std::string s = "{\"frontend\": \"native\", \"requests\": " +
                std::to_string(sv->requests.load()) + ", \"items\": " +
                std::to_string(it) + ", \"batches\": " +
                std::to_string(b) + ", \"mean_batch_size\": " +
                std::to_string(b ? double(it) / b : 0.0) +
                ", \"queue\": " + std::to_string(qd) +
                ", \"shed\": " + std::to_string(sv->shed.load()) +
                ", \"feat_items\": " +
                std::to_string(sv->feat_items.load()) +
                ", \"img_items\": " +
                std::to_string(sv->img_items.load()) +
                ", \"errors\": " + std::to_string(sv->errors.load()) + "}";
            respond(fd, 200, s, keep_alive);
            continue;
        }
        if (reqline.rfind("POST /v1/caption", 0) != 0) {
            respond(fd, 404, "{\"error\": \"no route\"}", keep_alive);
            continue;
        }
        if (!sv->ready.load()) {
            // pre-registration window (see Server::ready): serving a
            // caption request now would bypass id->row translation
            respond(fd, 503, "{\"error\": \"warming up\"}", keep_alive);
            continue;
        }
        sv->requests.fetch_add(1);
        std::vector<long long> ids;
        std::vector<std::shared_ptr<std::vector<float>>> feat_rows;
        std::vector<std::shared_ptr<std::string>> blobs;
        bool unsupported = false;
        if (!parse_ids(body, ids, unsupported))
            ids.clear();      // a failed parse may leave partial ids
        if (!ids.empty()) {
            // id fast path: translate to store rows here (parallel
            // connection threads) when the map is registered; unknown
            // ids 400 without ever touching the queue or the pump
            std::shared_ptr<const std::unordered_map<long long,
                                                     long long>> map;
            {
                std::lock_guard<std::mutex> lk(sv->id_rows_mu);
                map = sv->id_rows;
            }
            if (map) {
                long long bad = 0;
                bool ok = true;
                for (auto& v : ids) {
                    auto f = map->find(v);
                    if (f == map->end()) {
                        bad = v;
                        ok = false;
                        break;
                    }
                    v = f->second;
                }
                if (!ok) {
                    sv->errors.fetch_add(1);
                    respond(fd, 400, "{\"error\": \"unknown image id " +
                            std::to_string(bad) + "\"}", keep_alive);
                    continue;
                }
            }
        }
        if (ids.empty()) {
            bool is_feats = body.find("\"features\"") != std::string::npos;
            bool is_imgs = body.find("_b64\"") != std::string::npos;
            int dim = sv->feat_dim.load();
            if (is_feats && dim > 0) {
                std::string err;
                if (!parse_features(body, feat_rows, dim, err)) {
                    sv->errors.fetch_add(1);
                    respond(fd, 400, "{\"error\": \"" +
                            json_escape(err) + "\"}", keep_alive);
                    continue;
                }
                ids.assign(feat_rows.size(), -1);   // slot count only
            } else if (is_imgs && sv->images_ok.load()) {
                {
                    // backpressure BEFORE the JSON + base64 decode:
                    // past the knee, parsing multi-hundred-KB bodies
                    // that then shed burns the very core the image
                    // pipeline decodes on (measured: goodput halved
                    // when the full-queue check sat after the parse).
                    // And an INSTANT 503 is no better — closed-loop
                    // clients re-request immediately and the shed
                    // storm's socket reads burn the core instead
                    // (measured: 12.8k sheds/s, goodput 44 -> 15/s).
                    // So block THIS connection (it owns its thread)
                    // until the image thread drains room or the wait
                    // expires, then shed.  The post-parse capacity
                    // check below still closes the race.
                    std::unique_lock<std::mutex> lk(sv->bmu);
                    if (sv->blobq.size() >= sv->max_blobq) {
                        sv->bcv.wait_for(
                            lk, std::chrono::milliseconds(1000), [&] {
                                return sv->blobq.size() < sv->max_blobq
                                       || sv->stopping.load(); });
                        if (sv->blobq.size() >= sv->max_blobq) {
                            sv->shed.fetch_add(1);
                            lk.unlock();
                            respond(fd, 503,
                                    "{\"error\": \"image queue full\"}",
                                    keep_alive);
                            continue;
                        }
                    }
                }
                std::string err;
                if (!parse_images(body, blobs, err)) {
                    sv->errors.fetch_add(1);
                    respond(fd, 400, "{\"error\": \"" +
                            json_escape(err) + "\"}", keep_alive);
                    continue;
                }
                ids.assign(blobs.size(), -1);       // slot count only
            } else if (unsupported || is_feats || is_imgs) {
                sv->errors.fetch_add(1);
                respond(fd, 501,
                        "{\"error\": \"this capability is not enabled "
                        "on the native frontend; use the python "
                        "server\"}", keep_alive);
                continue;
            } else {
                sv->errors.fetch_add(1);
                respond(fd, 400, "{\"error\": \"body needs id or ids "
                        "(integers) or features (rows)\"}", keep_alive);
                continue;
            }
        }

        Request req;
        req.serial = sv->next_serial.fetch_add(1);
        req.ids = std::move(ids);
        req.captions.resize(req.ids.size());
        {
            std::lock_guard<std::mutex> lk(sv->live_mu);
            sv->live[req.serial] = &req;
        }
        if (!blobs.empty()) {   // image request -> the blob queue
            std::unique_lock<std::mutex> lk(sv->bmu);
            if (sv->blobq.size() + blobs.size() > sv->max_blobq) {
                lk.unlock();
                std::lock_guard<std::mutex> lk2(sv->live_mu);
                sv->live.erase(req.serial);
                sv->shed.fetch_add(1);
                respond(fd, 503, "{\"error\": \"image queue full\"}",
                        keep_alive);
                continue;
            }
            for (size_t s = 0; s < blobs.size(); s++)
                sv->blobq.push_back(Item{-1, req.serial, s, nullptr,
                                         blobs[s]});
            lk.unlock();
            sv->img_items.fetch_add((long long)blobs.size());
            sv->bcv.notify_all();
        } else {
            std::unique_lock<std::mutex> lk(sv->qmu);
            if (sv->queue.size() + req.ids.size() > sv->max_queue) {
                lk.unlock();
                std::lock_guard<std::mutex> lk2(sv->live_mu);
                sv->live.erase(req.serial);
                sv->shed.fetch_add(1);
                respond(fd, 503, "{\"error\": \"queue full\"}",
                        keep_alive);
                continue;
            }
            for (size_t s = 0; s < req.ids.size(); s++)
                sv->queue.push_back(Item{
                    req.ids[s], req.serial, s,
                    s < feat_rows.size() ? feat_rows[s] : nullptr,
                    nullptr});
            lk.unlock();
            if (!feat_rows.empty())
                sv->feat_items.fetch_add((long long)feat_rows.size());
            sv->qcv.notify_all();
        }

        bool timed_out = false;
        {   // wait for the pump to fill every slot (or error the request)
            std::unique_lock<std::mutex> lk(req.mu);
            timed_out = !req.cv.wait_for(
                lk, std::chrono::milliseconds(sv->request_timeout_ms),
                [&] { return req.done() || sv->stopping.load(); });
        }
        {
            std::lock_guard<std::mutex> lk(sv->live_mu);
            sv->live.erase(req.serial);
        }
        if (!req.done()) {
            // abandoned mid-flight (timeout / shutdown): drop any of the
            // request's items still queued so the pump doesn't decode
            // for a client that already got its error response
            {
                std::lock_guard<std::mutex> lk(sv->qmu);
                for (auto qi = sv->queue.begin();
                     qi != sv->queue.end();) {
                    if (qi->serial == req.serial)
                        qi = sv->queue.erase(qi);
                    else ++qi;
                }
            }
            std::lock_guard<std::mutex> bl(sv->bmu);
            bool purged = false;
            for (auto qi = sv->blobq.begin(); qi != sv->blobq.end();) {
                if (qi->serial == req.serial) {
                    qi = sv->blobq.erase(qi);
                    purged = true;
                } else ++qi;
            }
            if (purged) sv->bcv.notify_all();   // queue room appeared
        }
        if (req.error_status) {
            sv->errors.fetch_add(1);
            respond(fd, req.error_status,
                    "{\"error\": \"" + json_escape(req.error_msg) + "\"}",
                    keep_alive);
        } else if (timed_out && !req.done()) {
            sv->errors.fetch_add(1);
            respond(fd, 504, "{\"error\": \"request timed out waiting "
                    "for the device\"}", false);
            break;                       // slots may still fill; drop conn
        } else if (!req.done()) {        // server stopping mid-request
            respond(fd, 503, "{\"error\": \"shutting down\"}", false);
            break;
        } else {
            std::string out = "{\"captions\": [";
            for (size_t s = 0; s < req.captions.size(); s++) {
                if (s) out += ", ";
                out += "\"" + json_escape(req.captions[s]) + "\"";
            }
            out += "]}";
            respond(fd, 200, out, keep_alive);
        }
        if (!keep_alive) break;
    }
    ::close(fd);
}

}  // namespace

extern "C" {

void* lrcn_serve_start(const char* host, int port, int n_threads,
                       int max_queue, int request_timeout_ms) {
    auto* sv = new Server();
    sv->max_queue = max_queue > 0 ? (size_t)max_queue : 4096;
    if (request_timeout_ms > 0) sv->request_timeout_ms = request_timeout_ms;
    sv->listen_fd = ::socket(AF_INET, SOCK_STREAM, 0);
    if (sv->listen_fd < 0) { delete sv; return nullptr; }
    int one = 1;
    ::setsockopt(sv->listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof one);
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons((uint16_t)port);
    if (::inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
        // refuse non-numeric hosts: a zeroed sin_addr would silently
        // bind 0.0.0.0 (all interfaces) — the caller resolves names
        ::close(sv->listen_fd);
        delete sv;
        return nullptr;
    }
    if (::bind(sv->listen_fd, (sockaddr*)&addr, sizeof addr) < 0 ||
        ::listen(sv->listen_fd, 1024) < 0) {
        ::close(sv->listen_fd);
        delete sv;
        return nullptr;
    }
    socklen_t len = sizeof addr;
    ::getsockname(sv->listen_fd, (sockaddr*)&addr, &len);
    sv->port = ntohs(addr.sin_port);

    int threads = n_threads > 0 ? n_threads : 128;
    sv->acceptor = std::thread([sv, threads] {
        // thread-per-connection bounded by a semaphore-ish counter:
        // handler threads are detached; the stopping flag + closed
        // listener end them.
        std::atomic<int>* active = new std::atomic<int>(0);
        while (!sv->stopping.load()) {
            int fd = ::accept(sv->listen_fd, nullptr, nullptr);
            if (fd < 0) {
                if (sv->stopping.load()) break;        // listener closed
                if (errno == EMFILE || errno == ENFILE)  // fd pressure:
                    std::this_thread::sleep_for(         // shed + retry
                        std::chrono::milliseconds(10));
                if (errno == EBADF || errno == EINVAL) break;
                continue;   // ECONNABORTED / EINTR / transient
            }
            // reserve-then-check: fetch_add makes the limit exact even
            // under an accept burst (check-then-increment overshoots)
            if (active->fetch_add(1) >= threads) {   // saturated: shed
                active->fetch_sub(1);
                sv->shed.fetch_add(1);
                respond(fd, 503, "{\"error\": \"connection limit\"}",
                        false);
                ::close(fd);
                continue;
            }
            std::thread([sv, fd, active] {
                handle_connection(sv, fd);
                active->fetch_sub(1);
            }).detach();
        }
    });
    return sv;
}

int lrcn_serve_port(void* h) { return ((Server*)h)->port; }

// Pull a batch: block up to wait_ms for the first item, then keep
// collecting for up to fill_ms more — ending EARLY once `min_n` items
// are queued — before draining up to max_n. Returns n (0 on
// timeout/stop).
//
// The fill window is what keeps dispatches FULL under closed-loop
// load: responses go out in a batch-sized burst, the clients' next
// requests arrive over the following few ms, and a drain that fires
// on the first arrival would dispatch a sliver of the batch (measured:
// the knee sat at ~54% of the grouped-drain rate with fill_ms=0).
// `min_n` is the caller's arrival forecast (the pump passes the size
// of the batch it just responded to — closed-loop clients re-request
// immediately), so a full refill never waits out the deadline and a
// partial one is bounded by fill_ms.  min_n <= 0 (no forecast — e.g.
// pump startup, or nothing was responded since the last pull) skips
// the window entirely and drains whatever is queued.
// `feats` (capacity max_n * feat_dim floats) and `isfeat` (max_n
// flags) receive raw-feature items: item i with isfeat[i] != 0 has its
// fc7 row at feats + i * feat_dim and ids[i] == -1.  Callers that pass
// feats == nullptr (pre-feature pumps, unit tests) get feature items
// failed with 500 rather than silently mis-typed.
int lrcn_serve_next(void* h, long long* ids, long long* reqs,
                    long long* slots, float* feats,
                    unsigned char* isfeat, int max_n, int wait_ms,
                    int fill_ms, int min_n) {
    auto* sv = (Server*)h;
    if (min_n > max_n) min_n = max_n;
    int dim = sv->feat_dim.load();
    std::vector<long long> orphaned;   // feat items with no consumer
    std::unique_lock<std::mutex> lk(sv->qmu);
    if (sv->queue.empty()) {
        sv->qcv.wait_for(lk, std::chrono::milliseconds(wait_ms), [&] {
            return !sv->queue.empty() || sv->stopping.load(); });
    }
    if (!sv->queue.empty() && fill_ms > 0 && min_n > 0) {
        // wait until the expected batch arrives or the window closes; a
        // partial batch at the deadline drains as-is.  min_n <= 0 means
        // the caller has NO forecast — drain immediately rather than
        // burn the window hoping for max_n (which may even exceed
        // max_queue and so never arrive).
        size_t want = (size_t)min_n;
        if (want > sv->max_queue) want = sv->max_queue;
        if (sv->queue.size() < want)
            sv->qcv.wait_for(lk, std::chrono::milliseconds(fill_ms), [&] {
                return sv->queue.size() >= want || sv->stopping.load(); });
    }
    int n = 0;
    while (n < max_n && !sv->queue.empty()) {
        Item it = std::move(sv->queue.front());
        sv->queue.pop_front();
        if (it.feat) {
            if (feats == nullptr || dim <= 0) {
                orphaned.push_back(it.serial);
                continue;
            }
            std::memcpy(feats + (size_t)n * dim, it.feat->data(),
                        (size_t)dim * sizeof(float));
            if (isfeat) isfeat[n] = 1;
            ids[n] = -1;
        } else {
            if (isfeat) isfeat[n] = 0;
            ids[n] = it.id;
        }
        reqs[n] = it.serial;
        slots[n] = (long long)it.slot;
        n++;
    }
    lk.unlock();   // live_mu below must never nest inside qmu
    for (long long serial : orphaned) {
        std::lock_guard<std::mutex> live(sv->live_mu);
        auto li = sv->live.find(serial);
        if (li == sv->live.end()) continue;
        Request* r = li->second;
        std::lock_guard<std::mutex> rl(r->mu);
        r->error_status = 500;
        r->error_msg = "no feature consumer";
        r->cv.notify_all();
    }
    if (n) {
        sv->items.fetch_add(n);
        sv->batches.fetch_add(1);
    }
    return n;
}

// Register the fc7 row width; enables {"features": [[...], ...]}
// bodies (0 = disabled, the pre-registration default).
void lrcn_serve_set_feature_dim(void* h, int dim) {
    ((Server*)h)->feat_dim.store(dim > 0 ? dim : 0);
}

// Enable {"image_b64"/"images_b64"} bodies (the pump registers this
// only when its service has a VGG encoder).  `max_blobq` bounds the
// decoded-bytes backlog (memory: images are MBs each).
void lrcn_serve_set_image_support(void* h, int enabled, int max_blobq) {
    auto* sv = (Server*)h;
    sv->images_ok.store(enabled != 0);
    if (max_blobq > 0) sv->max_blobq = (size_t)max_blobq;
}

// Pull ONE decoded image blob: copies up to bufcap bytes into buf and
// returns the blob's size.  Returns 0 if nothing arrived within
// wait_ms, or -(size) if bufcap is too small (the item stays queued;
// call again with a bigger buffer).
long long lrcn_serve_next_image(void* h, long long* req, long long* slot,
                                char* buf, long long bufcap,
                                int wait_ms) {
    auto* sv = (Server*)h;
    std::unique_lock<std::mutex> lk(sv->bmu);
    if (sv->blobq.empty()) {
        sv->bcv.wait_for(lk, std::chrono::milliseconds(wait_ms), [&] {
            return !sv->blobq.empty() || sv->stopping.load(); });
    }
    if (sv->blobq.empty()) return 0;
    const Item& it = sv->blobq.front();
    long long sz = (long long)it.blob->size();
    if (sz > bufcap) return -sz;
    std::memcpy(buf, it.blob->data(), (size_t)sz);
    *req = it.serial;
    *slot = (long long)it.slot;
    sv->blobq.pop_front();
    // wake connection threads blocked on queue ROOM (the bounded
    // image backpressure above) — same condvar, opposite predicate
    sv->bcv.notify_all();
    return sz;
}

void fill_slot(Server* sv, long long serial, long long slot,
               std::string caption) {
    // caller holds live_mu
    auto it = sv->live.find(serial);
    if (it == sv->live.end()) return;           // connection went away
    Request* r = it->second;
    std::lock_guard<std::mutex> lk(r->mu);
    if (r->error_status) return;
    r->captions[(size_t)slot] = std::move(caption);
    r->filled++;
    if (r->done()) r->cv.notify_all();
}

// Fill caption slots; flushes any request whose slots are all filled.
void lrcn_serve_respond(void* h, const long long* reqs,
                        const long long* slots, const char** captions,
                        int n) {
    auto* sv = (Server*)h;
    std::lock_guard<std::mutex> live(sv->live_mu);
    for (int i = 0; i < n; i++)
        fill_slot(sv, reqs[i], slots[i], captions[i]);
}

// Register the id->word table once so lrcn_serve_respond_tokens can
// build captions from raw device tokens (no per-caption Python work).
void lrcn_serve_set_vocab(void* h, const char** words, int n) {
    auto* sv = (Server*)h;
    sv->vocab.assign(words, words + n);
}

// Register the image-id -> feature-store-row map once: connection
// threads then emit ROW indices through the queue (and 400 unknown
// ids at parse time), eliminating the pump's per-item Python row
// resolution.  Callable again to swap the map; n = 0 unregisters.
void lrcn_serve_set_id_rows(void* h, const long long* ids,
                            const long long* rows, long long n) {
    auto* sv = (Server*)h;
    std::shared_ptr<const std::unordered_map<long long, long long>> m;
    if (n > 0) {
        auto mm =
            std::make_shared<std::unordered_map<long long, long long>>();
        mm->reserve((size_t)n);
        for (long long i = 0; i < n; i++) (*mm)[ids[i]] = rows[i];
        m = std::move(mm);
    }
    std::lock_guard<std::mutex> lk(sv->id_rows_mu);
    sv->id_rows = std::move(m);
}

// Open the /v1/caption endpoint.  Called once by the Python side AFTER
// vocab + id->row registration and pump start; until then caption
// requests 503 (see Server::ready for why this is a correctness gate,
// not a nicety).
void lrcn_serve_ready(void* h) {
    ((Server*)h)->ready.store(true);
}

// Fill caption slots from RAW token rows. `tokens` is n rows of t_cap
// int32 ids; row layout matches decode/writer.py caption_to_line —
// tokens[0] is BOS (skipped), words accumulate until `eos_id`, and the
// caption line is "w1 w2 ... wn ." (reference lrcn.jl:634-640).
void lrcn_serve_respond_tokens(void* h, const long long* reqs,
                               const long long* slots,
                               const int* tokens, int t_cap,
                               int eos_id, int n) {
    auto* sv = (Server*)h;
    // detokenize BEFORE taking live_mu: every connection thread
    // acquires that lock twice per request, and a grouped respond
    // builds up to G*B caption strings — doing it under the lock
    // serializes request setup/teardown behind string work
    std::vector<std::string> caps((size_t)n);
    for (int i = 0; i < n; i++) {
        const int* row = tokens + (size_t)i * t_cap;
        std::string& cap = caps[(size_t)i];
        for (int t = 1; t < t_cap; t++) {
            if (row[t] == eos_id) break;
            if (row[t] < 0 || (size_t)row[t] >= sv->vocab.size())
                continue;                        // defensive: bad id
            cap += sv->vocab[(size_t)row[t]];
            cap += ' ';
        }
        cap += '.';
    }
    std::lock_guard<std::mutex> live(sv->live_mu);
    for (int i = 0; i < n; i++)
        fill_slot(sv, reqs[i], slots[i], std::move(caps[(size_t)i]));
}

// Fail one request (e.g. unknown id) with an HTTP status.
void lrcn_serve_error(void* h, long long req, int status,
                      const char* msg) {
    auto* sv = (Server*)h;
    std::lock_guard<std::mutex> live(sv->live_mu);
    auto it = sv->live.find(req);
    if (it == sv->live.end()) return;
    Request* r = it->second;
    std::lock_guard<std::mutex> lk(r->mu);
    r->error_status = status;
    r->error_msg = msg ? msg : "error";
    r->cv.notify_all();
}

void lrcn_serve_stop(void* h) {
    auto* sv = (Server*)h;
    sv->stopping.store(true);
    ::shutdown(sv->listen_fd, SHUT_RDWR);
    ::close(sv->listen_fd);
    sv->qcv.notify_all();
    sv->bcv.notify_all();
    {   // wake every waiting connection thread
        std::lock_guard<std::mutex> live(sv->live_mu);
        for (auto& [serial, r] : sv->live) {
            std::lock_guard<std::mutex> lk(r->mu);
            r->cv.notify_all();
        }
    }
    if (sv->acceptor.joinable()) sv->acceptor.join();
    // connection threads are detached and may wake from their 5s recv
    // timeout AFTER stop returns; the Server object is deliberately
    // leaked (one small allocation per process lifetime) so a late
    // waker can never touch freed memory.
    std::this_thread::sleep_for(std::chrono::milliseconds(50));
}

}  // extern "C"
