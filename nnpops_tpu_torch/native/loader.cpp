// Native host-side runtime of nnpops_tpu_torch (the port's copy of
// nnpops_tpu/native/loader.cpp): bulk molecule loading (mol2, PDB with its
// CRYST1 box) and neighbor-capacity planning.
//
// It covers the host-side work the reference implements in C++ (its
// benchmark binaries parse PDB by hand) -- file ingestion and the O(N)
// estimate of the static capacities (neighbor capacity K, cell capacity C)
// that size the device buffers.
//
// A plain C ABI loaded through ctypes (no pybind11, no PyTorch headers).
// Built by nnpops_tpu_torch/native/__init__.py into nnpops_tpu_torch/_build/:
//   g++ -O3 -shared -fPIC -std=c++17 loader.cpp -o libnnpops_host.so

#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

int element_from_letters(const char* s, bool allow_metals = true) {
    // Two-letter symbols first, then single letters. Atom-NAME-derived
    // lookups must pass allow_metals=false: ligand names like "NAD" or "CA"
    // are nitrogens/carbons, not sodium/calcium (matches utils/io.py).
    char a = toupper(s[0]);
    char b = s[1] ? toupper(s[1]) : 0;
    if (a == 'C' && b == 'L') return 17;
    if (a == 'B' && b == 'R') return 35;
    if (allow_metals) {
        if (a == 'N' && b == 'A') return 11;
        if (a == 'M' && b == 'G') return 12;
        if (a == 'Z' && b == 'N') return 30;
        if (a == 'F' && b == 'E') return 26;
    }
    switch (a) {
        case 'H': return 1;  case 'B': return 5;  case 'C': return 6;
        case 'N': return 7;  case 'O': return 8;  case 'F': return 9;
        case 'P': return 15; case 'S': return 16; case 'K': return 19;
        case 'I': return 53;
    }
    return -1;
}

struct ParsedSystem {
    std::vector<float> positions;   // 3N
    std::vector<int32_t> numbers;   // N
    float box[9];
    bool has_box = false;
};

bool read_file(const char* path, std::string* out) {
    FILE* f = fopen(path, "rb");
    if (!f) return false;
    fseek(f, 0, SEEK_END);
    long size = ftell(f);
    fseek(f, 0, SEEK_SET);
    out->resize(size);
    size_t got = fread(&(*out)[0], 1, size, f);
    fclose(f);
    return got == static_cast<size_t>(size);
}

// --- mol2 -------------------------------------------------------------------

bool parse_mol2(const std::string& text, ParsedSystem* sys) {
    const char* p = text.c_str();
    const char* atoms = strstr(p, "@<TRIPOS>ATOM");
    if (!atoms) return false;
    atoms = strchr(atoms, '\n');
    if (!atoms) return false;
    ++atoms;
    while (*atoms && *atoms != '@') {
        // Fields: id name x y z type [...]
        char name[32] = {0}, type[32] = {0};
        float x, y, z;
        int id;
        int n = sscanf(atoms, " %d %31s %f %f %f %31s", &id, name, &x, &y, &z, type);
        if (n == 6) {
            int elem = -1;
            // SYBYL type starts uppercase; force-field types need the name.
            if (isupper((unsigned char)type[0])) {
                char head[3] = {type[0], (char)(type[1] == '.' ? 0 : type[1]), 0};
                elem = element_from_letters(head);
            }
            if (elem < 0) {
                char letters[8] = {0};
                int k = 0;
                for (int i = 0; name[i] && k < 7; ++i)
                    if (isalpha((unsigned char)name[i])) letters[k++] = name[i];
                elem = element_from_letters(letters, /*allow_metals=*/false);
            }
            if (elem < 0) return false;
            sys->positions.push_back(x);
            sys->positions.push_back(y);
            sys->positions.push_back(z);
            sys->numbers.push_back(elem);
        }
        atoms = strchr(atoms, '\n');
        if (!atoms) break;
        ++atoms;
    }
    return !sys->numbers.empty();
}

// --- pdb --------------------------------------------------------------------

void cryst1_to_reduced(float a, float b, float c, float alpha_deg,
                       float beta_deg, float gamma_deg, float* box) {
    const float d2r = 3.14159265358979323846f / 180.0f;
    float alpha = alpha_deg * d2r, beta = beta_deg * d2r, gamma = gamma_deg * d2r;
    float av[3] = {a, 0, 0};
    float bv[3] = {b * cosf(gamma), b * sinf(gamma), 0};
    float cx = c * cosf(beta);
    float cy = c * (cosf(alpha) - cosf(beta) * cosf(gamma)) / sinf(gamma);
    float arg = c * c - cx * cx - cy * cy;
    float cv[3] = {cx, cy, arg > 0 ? sqrtf(arg) : 0};
    // Reduce to the lower-triangular canonical form.
    float s = roundf(cv[1] / bv[1]);
    for (int i = 0; i < 2; ++i) cv[i] -= s * bv[i];
    s = roundf(cv[0] / av[0]);
    cv[0] -= s * av[0];
    s = roundf(bv[0] / av[0]);
    bv[0] -= s * av[0];
    box[0] = av[0]; box[1] = av[1]; box[2] = av[2];
    box[3] = bv[0]; box[4] = bv[1]; box[5] = bv[2];
    box[6] = cv[0]; box[7] = cv[1]; box[8] = cv[2];
}

bool parse_pdb(const std::string& text, ParsedSystem* sys) {
    const char* line = text.c_str();
    while (line && *line) {
        const char* eol = strchr(line, '\n');
        size_t len = eol ? (size_t)(eol - line) : strlen(line);
        if (len >= 6 && strncmp(line, "CRYST1", 6) == 0 && len >= 54) {
            float a = strtof(std::string(line + 6, 9).c_str(), nullptr);
            float b = strtof(std::string(line + 15, 9).c_str(), nullptr);
            float c = strtof(std::string(line + 24, 9).c_str(), nullptr);
            float al = strtof(std::string(line + 33, 7).c_str(), nullptr);
            float be = strtof(std::string(line + 40, 7).c_str(), nullptr);
            float ga = strtof(std::string(line + 47, 7).c_str(), nullptr);
            cryst1_to_reduced(a, b, c, al, be, ga, sys->box);
            sys->has_box = true;
        } else if (len >= 54 && (strncmp(line, "ATOM  ", 6) == 0 ||
                                 strncmp(line, "HETATM", 6) == 0)) {
            float x = strtof(std::string(line + 30, 8).c_str(), nullptr);
            float y = strtof(std::string(line + 38, 8).c_str(), nullptr);
            float z = strtof(std::string(line + 46, 8).c_str(), nullptr);
            int elem = -1;
            if (len >= 78) {
                char sym[3] = {0};
                int k = 0;
                for (int i = 76; i < 78 && (size_t)i < len; ++i)
                    if (isalpha((unsigned char)line[i])) sym[k++] = line[i];
                if (k) elem = element_from_letters(sym);
            }
            if (elem < 0) {
                char letters[5] = {0};
                int k = 0;
                for (int i = 12; i < 16 && (size_t)i < len; ++i)
                    if (isalpha((unsigned char)line[i]) && k < 4)
                        letters[k++] = line[i];
                elem = element_from_letters(letters, /*allow_metals=*/false);
            }
            if (elem < 0) return false;
            sys->positions.push_back(x);
            sys->positions.push_back(y);
            sys->positions.push_back(z);
            sys->numbers.push_back(elem);
        }
        line = eol ? eol + 1 : nullptr;
    }
    return !sys->numbers.empty();
}

}  // namespace

extern "C" {

// Opaque handle API: load -> query sizes -> copy out -> free.
void* nnpops_load(const char* path) {
    std::string text;
    if (!read_file(path, &text)) return nullptr;
    auto* sys = new ParsedSystem();
    size_t n = strlen(path);
    bool ok = false;
    if (n > 5 && strcmp(path + n - 5, ".mol2") == 0)
        ok = parse_mol2(text, sys);
    else
        ok = parse_pdb(text, sys);
    if (!ok) {
        delete sys;
        return nullptr;
    }
    return sys;
}

int32_t nnpops_num_atoms(void* handle) {
    return static_cast<ParsedSystem*>(handle)->numbers.size();
}

int32_t nnpops_has_box(void* handle) {
    return static_cast<ParsedSystem*>(handle)->has_box ? 1 : 0;
}

void nnpops_copy(void* handle, float* positions, int32_t* numbers, float* box) {
    auto* sys = static_cast<ParsedSystem*>(handle);
    memcpy(positions, sys->positions.data(), sys->positions.size() * sizeof(float));
    memcpy(numbers, sys->numbers.data(), sys->numbers.size() * sizeof(int32_t));
    if (sys->has_box) memcpy(box, sys->box, 9 * sizeof(float));
}

void nnpops_free(void* handle) {
    delete static_cast<ParsedSystem*>(handle);
}

// Neighbor-capacity planner: exact max neighbor count within `cutoff` (and
// within `cutoff2` if > 0) plus max cell occupancy for `cell_size`, via a
// host-side cell list. Used to size the static shapes (K, K_ang, C) before
// the device buffers are made, so capacity overflow never happens at runtime. box may be null
// (non-periodic). O(N) with small constants; 26k atoms in ~ms.
void nnpops_plan_capacities(const float* positions, int32_t num_atoms,
                            const float* box, float cutoff, float cutoff2,
                            float cell_size, int32_t* out) {
    // out[0] = max neighbors within cutoff, out[1] = max within cutoff2,
    // out[2] = max cell occupancy at cell_size.
    float lo[3] = {1e30f, 1e30f, 1e30f}, hi[3] = {-1e30f, -1e30f, -1e30f};
    for (int i = 0; i < num_atoms; ++i)
        for (int d = 0; d < 3; ++d) {
            float v = positions[3 * i + d];
            if (v < lo[d]) lo[d] = v;
            if (v > hi[d]) hi[d] = v;
        }
    float ext[3], origin[3];
    bool periodic = box != nullptr;
    for (int d = 0; d < 3; ++d) {
        ext[d] = periodic ? box[4 * d] : (hi[d] - lo[d] + 1e-3f);
        origin[d] = periodic ? 0.0f : lo[d];
    }
    bool triclinic = periodic && (box[3] != 0 || box[6] != 0 || box[7] != 0);
    int nc[3];
    for (int d = 0; d < 3; ++d) {
        // Orthogonal binning is only neighbor-complete for rectangular boxes;
        // for triclinic ones fall back to a single cell (exact O(N^2) scan —
        // this is a one-time planner, not the per-step path).
        nc[d] = triclinic ? 1 : (int)floorf(ext[d] / cell_size);
        if (nc[d] < 1) nc[d] = 1;
    }
    int total_cells = nc[0] * nc[1] * nc[2];
    std::vector<std::vector<int>> cells(total_cells);
    std::vector<int> cell_of(num_atoms);
    for (int i = 0; i < num_atoms; ++i) {
        int c3[3];
        for (int d = 0; d < 3; ++d) {
            float f = (positions[3 * i + d] - origin[d]) / ext[d];
            f -= floorf(f);
            int c = (int)(f * nc[d]);
            if (c >= nc[d]) c = nc[d] - 1;
            c3[d] = c;
        }
        int cid = (c3[0] * nc[1] + c3[1]) * nc[2] + c3[2];
        cells[cid].push_back(i);
        cell_of[i] = cid;
    }
    int max_occ = 0;
    for (auto& v : cells)
        if ((int)v.size() > max_occ) max_occ = (int)v.size();

    float cut_sq = cutoff * cutoff;
    float cut2_sq = cutoff2 > 0 ? cutoff2 * cutoff2 : 0;
    int max_n1 = 0, max_n2 = 0;
    for (int i = 0; i < num_atoms; ++i) {
        int cid = cell_of[i];
        int cz = cid % nc[2];
        int cy = (cid / nc[2]) % nc[1];
        int cx = cid / (nc[1] * nc[2]);
        int n1 = 0, n2 = 0;
        for (int ox = -1; ox <= 1; ++ox)
            for (int oy = -1; oy <= 1; ++oy)
                for (int oz = -1; oz <= 1; ++oz) {
                    int qx = (cx + ox + nc[0]) % nc[0];
                    int qy = (cy + oy + nc[1]) % nc[1];
                    int qz = (cz + oz + nc[2]) % nc[2];
                    // With <3 cells along an axis the stencil aliases; a
                    // visited-set would be needed for exactness, but for the
                    // planner an over-count is safe (capacities are upper
                    // bounds) and duplicates only occur in degenerate boxes.
                    int qid = (qx * nc[1] + qy) * nc[2] + qz;
                    for (int j : cells[qid]) {
                        if (j == i) continue;
                        float dx = positions[3 * j] - positions[3 * i];
                        float dy = positions[3 * j + 1] - positions[3 * i + 1];
                        float dz = positions[3 * j + 2] - positions[3 * i + 2];
                        if (periodic) {
                            // Reduced-form minimum image: c, then b, then a
                            // (same order as geometry.minimum_image).
                            float s3 = roundf(dz / box[8]);
                            dx -= s3 * box[6]; dy -= s3 * box[7]; dz -= s3 * box[8];
                            float s2 = roundf(dy / box[4]);
                            dx -= s2 * box[3]; dy -= s2 * box[4];
                            float s1 = roundf(dx / box[0]);
                            dx -= s1 * box[0];
                        }
                        float r2 = dx * dx + dy * dy + dz * dz;
                        if (r2 < cut_sq) ++n1;
                        if (cut2_sq > 0 && r2 < cut2_sq) ++n2;
                    }
                }
        if (n1 > max_n1) max_n1 = n1;
        if (n2 > max_n2) max_n2 = n2;
    }
    out[0] = max_n1;
    out[1] = max_n2;
    out[2] = max_occ;
}

}  // extern "C"
