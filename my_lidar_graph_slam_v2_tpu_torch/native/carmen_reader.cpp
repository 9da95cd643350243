// Native Carmen log parser (data-loader layer).
//
// C++ counterpart of io/carmen.py, mirroring the reference's
// src/my_lidar_graph_slam/io/carmen/carmen_reader.cpp record handling
// (PARAM, ODOM, FLASER/RLASER old format, RAWLASER1-4 / ROBOTLASER1-2 new
// format; best-effort skip of malformed lines).  Exposes a C ABI consumed
// via ctypes: records are exported as packed double arrays so one call
// moves the whole log across the boundary.
//
// Build: g++ -O3 -shared -fPIC (see native/__init__.py::_build).

#include <cctype>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct OdomRec {
    double order;  // index in the merged record stream
    double ts, x, y, th, tv, rv;
};

struct ScanRec {
    double order;
    double ts;
    double robot[3];
    double rel_sensor[3];
    double min_range, max_range;
    double min_angle, max_angle;
    double start_angle, angle_inc;
    long n_ranges;
    long range_offset;  // into the shared ranges array
};

struct Log {
    std::vector<OdomRec> odoms;
    std::vector<ScanRec> scans;
    std::vector<double> ranges;
};

double guess_angle_range(long n) {
    // carmen_reader.cpp:466-487
    if (n == 181) return M_PI;
    if (n == 180) return M_PI * 179.0 / 180.0;
    if (n == 361) return M_PI;
    if (n == 360) return M_PI * 359.0 / 360.0;
    if (n == 401) return M_PI * 100.0 / 180.0;
    if (n == 400) return M_PI * 99.75 / 180.0;
    return M_PI;
}

// SE(2) inverse compound: diff such that start (+) diff = end.
void inverse_compound(const double s[3], const double e[3], double out[3]) {
    const double dx = e[0] - s[0], dy = e[1] - s[1];
    const double c = std::cos(s[2]), sn = std::sin(s[2]);
    out[0] = c * dx + sn * dy;
    out[1] = -sn * dx + c * dy;
    double dt = e[2] - s[2];
    while (dt > M_PI) dt -= 2.0 * M_PI;
    while (dt < -M_PI) dt += 2.0 * M_PI;
    out[2] = dt;
}

struct Tokens {
    std::vector<const char*> tok;
    // Tokenize in place: replaces whitespace with NULs.
    explicit Tokens(char* line) {
        char* p = line;
        while (*p) {
            while (*p && std::isspace((unsigned char)*p)) *p++ = '\0';
            if (*p) {
                tok.push_back(p);
                while (*p && !std::isspace((unsigned char)*p)) ++p;
            }
        }
    }
    size_t size() const { return tok.size(); }
    const char* operator[](size_t i) const { return tok[i]; }
    bool num(size_t i, double* out) const {
        if (i >= tok.size()) return false;
        char* end = nullptr;
        *out = std::strtod(tok[i], &end);
        return end != tok[i] && *end == '\0';
    }
    bool integer(size_t i, long* out) const {
        double d;
        if (!num(i, &d)) return false;
        *out = (long)d;
        return true;
    }
};

bool parse_odom(const Tokens& t, double order, Log* log) {
    // ODOM x y th tv rv accel ts [host ...]
    double x, y, th, tv, rv, ts;
    if (!t.num(1, &x) || !t.num(2, &y) || !t.num(3, &th) ||
        !t.num(4, &tv) || !t.num(5, &rv) || !t.num(7, &ts))
        return false;
    log->odoms.push_back({order, ts, x, y, th, tv, rv});
    return true;
}

bool parse_old_laser(const Tokens& t,
                     const std::unordered_map<std::string, double>& params,
                     const std::unordered_map<std::string, bool>& has,
                     double order, Log* log) {
    // FLASER n r0..r{n-1} lx ly lth rx ry rth ts [host ...]
    long n;
    if (!t.integer(1, &n) || n <= 0 || (long)t.size() < n + 8) return false;
    ScanRec s{};
    s.order = order;
    s.range_offset = (long)log->ranges.size();
    s.n_ranges = n;
    for (long i = 0; i < n; ++i) {
        double r;
        if (!t.num(2 + i, &r)) {
            log->ranges.resize(s.range_offset);
            return false;
        }
        log->ranges.push_back(r);
    }
    double laser[3], robot[3];
    for (int i = 0; i < 3; ++i)
        if (!t.num(2 + n + i, &laser[i])) return false;
    for (int i = 0; i < 3; ++i)
        if (!t.num(5 + n + i, &robot[i])) return false;
    if (!t.num(8 + n, &s.ts)) s.ts = 0.0;
    std::memcpy(s.robot, robot, sizeof robot);
    inverse_compound(robot, laser, s.rel_sensor);

    auto get = [&](const char* k, double dflt) {
        auto it = params.find(k);
        return it == params.end() ? dflt : it->second;
    };
    s.min_range = get("Laser.MinRange", 0.0);
    s.max_range = get("Laser.MaxRange", 80.0);
    const bool has_inc = has.count("Laser.AngleIncrement") > 0;
    s.angle_inc = has_inc ? params.at("Laser.AngleIncrement")
                          : guess_angle_range(n) / (double)(n > 1 ? n - 1 : 1);
    s.min_angle = get("Laser.MinAngle", -M_PI / 2.0);
    if (has.count("Laser.MaxAngle"))
        s.max_angle = params.at("Laser.MaxAngle");
    else if (has_inc)
        s.max_angle = s.min_angle + s.angle_inc * (double)n;
    else
        s.max_angle = s.min_angle + guess_angle_range(n);
    s.start_angle = s.min_angle;
    log->scans.push_back(s);
    return true;
}

bool parse_raw_laser(const Tokens& t, bool robot_fmt, double order, Log* log) {
    // RAWLASERi type start_angle fov angular_res max_range accuracy
    //           remission_mode n r0..r{n-1} nrem rem.. [robot fields] ts
    double start_angle, angular_res, max_range;
    long n;
    if (!t.num(2, &start_angle) || !t.num(4, &angular_res) ||
        !t.num(5, &max_range) || !t.integer(8, &n) || n <= 0 ||
        (long)t.size() < 9 + n)
        return false;
    ScanRec s{};
    s.order = order;
    s.range_offset = (long)log->ranges.size();
    s.n_ranges = n;
    for (long i = 0; i < n; ++i) {
        double r;
        if (!t.num(9 + i, &r)) {
            log->ranges.resize(s.range_offset);
            return false;
        }
        log->ranges.push_back(r);
    }
    size_t pos = 9 + (size_t)n;
    long num_rem = 0;
    if (!t.integer(pos, &num_rem)) {
        log->ranges.resize(s.range_offset);
        return false;
    }
    pos += 1 + (size_t)num_rem;
    if (robot_fmt) {
        double laser[3], robot[3];
        for (int i = 0; i < 3; ++i)
            if (!t.num(pos + i, &laser[i])) {
                log->ranges.resize(s.range_offset);
                return false;
            }
        for (int i = 0; i < 3; ++i)
            if (!t.num(pos + 3 + i, &robot[i])) {
                log->ranges.resize(s.range_offset);
                return false;
            }
        std::memcpy(s.robot, robot, sizeof robot);
        inverse_compound(robot, laser, s.rel_sensor);
        pos += 6 + 2 + 3;  // + laser velocity (2) + safety/turn axis (3)
    }
    if (!t.num(pos, &s.ts)) s.ts = 0.0;
    s.min_range = 0.0;
    s.max_range = max_range;
    s.min_angle = start_angle;
    s.max_angle = start_angle + angular_res * (double)(n - 1);
    s.start_angle = start_angle;
    s.angle_inc = angular_res;
    log->scans.push_back(s);
    return true;
}

}  // namespace

extern "C" {

void* carmen_load(const char* path) {
    FILE* f = std::fopen(path, "r");
    if (!f) return nullptr;
    auto* log = new Log();
    std::unordered_map<std::string, double> params;
    std::unordered_map<std::string, bool> has;
    std::string line;
    char buf[1 << 16];
    long order = 0;
    while (std::fgets(buf, sizeof buf, f)) {
        line.assign(buf);
        // Long lines (scans can exceed 64 KiB): keep appending.
        while (!line.empty() && line.back() != '\n' &&
               std::fgets(buf, sizeof buf, f))
            line.append(buf);
        if (line.empty() || line[0] == '#') continue;
        std::vector<char> mut(line.begin(), line.end());
        mut.push_back('\0');
        Tokens t(mut.data());
        if (t.size() == 0) continue;
        const char* tag = t[0];
        bool ok = false;
        if (std::strcmp(tag, "PARAM") == 0 && t.size() >= 3) {
            char* end = nullptr;
            double v = std::strtod(t[2], &end);
            if (end != t[2] && *end == '\0') {
                params[t[1]] = v;
                has[t[1]] = true;
            }
            continue;  // params are not stream records
        } else if (std::strcmp(tag, "ODOM") == 0) {
            ok = parse_odom(t, (double)order, log);
        } else if (std::strcmp(tag, "FLASER") == 0 ||
                   std::strcmp(tag, "RLASER") == 0) {
            ok = parse_old_laser(t, params, has, (double)order, log);
        } else if (std::strncmp(tag, "RAWLASER", 8) == 0 &&
                   std::strlen(tag) == 9) {
            ok = parse_raw_laser(t, /*robot_fmt=*/false, (double)order, log);
        } else if (std::strncmp(tag, "ROBOTLASER", 10) == 0 &&
                   std::strlen(tag) == 11) {
            ok = parse_raw_laser(t, /*robot_fmt=*/true, (double)order, log);
        }
        if (ok) ++order;
    }
    std::fclose(f);
    return log;
}

void carmen_free(void* h) { delete static_cast<Log*>(h); }

long carmen_n_odom(void* h) {
    return (long)static_cast<Log*>(h)->odoms.size();
}
long carmen_n_scan(void* h) {
    return (long)static_cast<Log*>(h)->scans.size();
}
long carmen_total_ranges(void* h) {
    return (long)static_cast<Log*>(h)->ranges.size();
}

// [n_odom, 7]: order, ts, x, y, th, tv, rv
void carmen_export_odom(void* h, double* out) {
    for (const auto& o : static_cast<Log*>(h)->odoms) {
        *out++ = o.order;
        *out++ = o.ts;
        *out++ = o.x;
        *out++ = o.y;
        *out++ = o.th;
        *out++ = o.tv;
        *out++ = o.rv;
    }
}

// [n_scan, 16]: order, ts, rx, ry, rth, sx, sy, sth, min_range, max_range,
//               min_angle, max_angle, start_angle, angle_inc, n, offset
void carmen_export_scan_meta(void* h, double* out) {
    for (const auto& s : static_cast<Log*>(h)->scans) {
        *out++ = s.order;
        *out++ = s.ts;
        *out++ = s.robot[0];
        *out++ = s.robot[1];
        *out++ = s.robot[2];
        *out++ = s.rel_sensor[0];
        *out++ = s.rel_sensor[1];
        *out++ = s.rel_sensor[2];
        *out++ = s.min_range;
        *out++ = s.max_range;
        *out++ = s.min_angle;
        *out++ = s.max_angle;
        *out++ = s.start_angle;
        *out++ = s.angle_inc;
        *out++ = (double)s.n_ranges;
        *out++ = (double)s.range_offset;
    }
}

void carmen_export_ranges(void* h, double* out) {
    const auto& r = static_cast<Log*>(h)->ranges;
    std::memcpy(out, r.data(), r.size() * sizeof(double));
}

}  // extern "C"
