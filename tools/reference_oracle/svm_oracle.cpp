// svm_oracle: predict with the reference's UNMODIFIED LIBSVM fork from a
// text model file plus dense precomputed-kernel rows.
//
// Links libsvm-code/svm.cpp verbatim (read-only reference checkout) as a
// test oracle: if this binary, whose parsing and prediction code is the
// reference's own (svm_load_model svm.cpp:2903-3010, svm_predict_values
// svm.cpp:2521-2616), reproduces fastsk_jax's predictions from a model
// file written by fastsk_jax.svm.libsvm_io, the text format is truly
// interoperable — not merely round-trippable through our own reader.
//
// usage: svm_oracle <model.txt> <kernel_rows.csv>
//   kernel_rows.csv: one test point per line, comma- or space-separated
//   K(test, train_j) for j = 1..n_train (dense, in training order).
// output per line: <pred> <dec_1> ... <dec_k> [p_1 ... p_nc]
//   decisions follow LIBSVM's OvO pair order; probabilities only when the
//   model carries probA/probB.
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include "libsvm-code/svm.h"

// The fork's svm_load_model has a latent heap overflow: sv_indices is
// allocated with l ints (svm.cpp:2977) but written at the GLOBAL x_space
// node counter j, which advances past the per-SV terminator nodes
// (svm.cpp:2995), reaching 2*(l-1) for one-node-per-SV precomputed
// models — dead code in the reference because nothing in its builds ever
// loads a model (svm-predict.c is unbuilt, SURVEY C12). To observe the
// reference's parsing/prediction behavior without the corruption, the
// build wraps malloc (-Wl,--wrap=malloc) to leave slack; sv_indices
// content is never read on the PRECOMPUTED predict path.
extern "C" void *__real_malloc(size_t);
extern "C" void *__wrap_malloc(size_t n) { return __real_malloc(2 * n + 64); }

static std::vector<double> parse_row(const std::string &line) {
    std::vector<double> vals;
    const char *p = line.c_str();
    char *end;
    while (*p) {
        while (*p == ',' || *p == ' ' || *p == '\t') p++;
        if (!*p) break;
        double v = strtod(p, &end);
        if (end == p) break;
        vals.push_back(v);
        p = end;
    }
    return vals;
}

int main(int argc, char **argv) {
    if (argc != 3) {
        fprintf(stderr, "usage: %s <model.txt> <kernel_rows.csv>\n", argv[0]);
        return 2;
    }
    svm_model *model = svm_load_model(argv[1]);
    if (!model) {
        fprintf(stderr, "failed to load model %s\n", argv[1]);
        return 1;
    }
    bool prob = svm_check_probability_model(model) != 0;
    int nc = model->nr_class;
    int ndec = (model->param.svm_type == ONE_CLASS ||
                model->param.svm_type == EPSILON_SVR ||
                model->param.svm_type == NU_SVR)
                   ? 1
                   : nc * (nc - 1) / 2;

    FILE *f = fopen(argv[2], "r");
    if (!f) {
        fprintf(stderr, "failed to open %s\n", argv[2]);
        return 1;
    }
    // getline grows the buffer: a %.17g kernel row over a 40k+ sequence
    // training set tops 1 MB, and a fixed fgets buffer would silently
    // split it into extra misaligned "test points"
    char *buf = nullptr;
    size_t cap = 0;
    std::vector<double> dec(ndec), pr(nc > 0 ? nc : 1);
    while (getline(&buf, &cap, f) != -1) {
        std::vector<double> row = parse_row(buf);
        if (row.empty()) continue;
        // dense PRECOMPUTED node row: position j holds K(test, train_j),
        // position 0 is the (unused at predict time) serial slot —
        // k_function PRECOMPUTED indexes x[(int)SV->value].value
        std::vector<svm_node> x(row.size() + 2);
        x[0].index = 0;
        x[0].value = 0.0;
        for (size_t j = 0; j < row.size(); j++) {
            x[j + 1].index = (int)(j + 1);
            x[j + 1].value = row[j];
        }
        x[row.size() + 1].index = -1;
        double pred = svm_predict_values(model, x.data(), dec.data());
        printf("%.17g", pred);
        for (int d = 0; d < ndec; d++) printf(" %.17g", dec[d]);
        if (prob) {
            svm_predict_probability(model, x.data(), pr.data());
            for (int c = 0; c < nc; c++) printf(" %.17g", pr[c]);
        }
        printf("\n");
    }
    free(buf);
    fclose(f);
    svm_free_and_destroy_model(&model);
    return 0;
}
