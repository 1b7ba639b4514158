// An external operator library for the port's tests and phase 14 of
// chip_smoke.py: the ops of tests/test_library.py's library under names
// of their own (the op ABI of mxnet_tpu_torch/library.py).
#include <cstdint>
#include <cstddef>
extern "C" {
int mxtpu_lib_init() { return 0; }
int mxtpu_lib_num_ops() { return 2; }
const char* mxtpu_lib_op_name(int idx) {
    return idx == 0 ? "port_ext_square" : "port_ext_addmul";
}
int mxtpu_lib_op_num_inputs(int idx) { return idx == 0 ? 1 : 2; }

static int64_t numel(const int64_t* shape, int ndim) {
    int64_t n = 1;
    for (int i = 0; i < ndim; ++i) n *= shape[i];
    return n;
}

int mxtpu_lib_op_forward(int idx, int n_inputs, const float** inputs,
                         const int64_t** shapes, const int* ndims,
                         float* output) {
    int64_t n = numel(shapes[0], ndims[0]);
    if (idx == 0) {
        for (int64_t i = 0; i < n; ++i)
            output[i] = inputs[0][i] * inputs[0][i];
    } else {
        if (n_inputs != 2) return 1;
        for (int64_t i = 0; i < n; ++i)
            output[i] = inputs[0][i] + 2.0f * inputs[1][i];
    }
    return 0;
}

int mxtpu_lib_op_backward(int idx, int n_inputs, const float* out_grad,
                          const float** inputs, const int64_t** shapes,
                          const int* ndims, float* in_grad0) {
    int64_t n = numel(shapes[0], ndims[0]);
    for (int64_t i = 0; i < n; ++i)
        in_grad0[i] = 2.0f * inputs[0][i] * out_grad[i];
    return 0;
}
}
