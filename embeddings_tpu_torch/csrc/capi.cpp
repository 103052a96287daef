/* C ABI host of the PyTorch port: the ABI of native/embeddings_c.h
 * (the reference's libbert.so surface, bert.h:33-90), served by the
 * port's Engine (embeddings_tpu_torch.runtime.engine) in an embedded
 * CPython interpreter. The compute path is the port's: the hand-written
 * CUDA kernels on the card. This file is the FFI layer: interpreter
 * lifecycle, GIL management, UTF-8/buffer marshalling, error reporting.
 *
 * Device: the ABI has no device argument. The engine runs on the device
 * named by EMBEDDINGS_TPU_TORCH_DEVICE, "cuda" when it is unset; without
 * a CUDA device et_load_from_file returns NULL and et_last_error() names
 * the device (the engine never falls back to the CPU on its own).
 *
 * The repository root the library was built from (ET_REPO_ROOT, fixed
 * at build time) goes on sys.path when the package is not importable
 * otherwise. When this library starts the
 * interpreter, it does so as the interpreter that built it
 * (ET_PYTHON_EXECUTABLE, fixed at build time), so its site-packages
 * (torch) are found. Loaded into a process that already runs Python
 * (ctypes), it uses that interpreter. It never finalizes the
 * interpreter: the CUDA context lives until the process ends.
 *
 * Build: embeddings_tpu_torch.capi.build()
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstring>
#include <mutex>
#include <string>
#include <vector>

#include "embeddings_c.h"

namespace {

thread_local std::string g_error;

void set_error(const std::string &msg) { g_error = msg; }

/* Capture the current Python exception into g_error. */
void set_error_from_python() {
    PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
    PyErr_Fetch(&type, &value, &tb);
    PyErr_NormalizeException(&type, &value, &tb);
    std::string msg = "python error";
    if (value) {
        PyObject *s = PyObject_Str(value);
        if (s) {
            const char *c = PyUnicode_AsUTF8(s);
            if (c) msg = c;
            Py_DECREF(s);
        }
    }
    if (type) {
        PyObject *n = PyObject_GetAttrString(type, "__name__");
        if (n) {
            const char *c = PyUnicode_AsUTF8(n);
            if (c) msg = std::string(c) + ": " + msg;
            Py_DECREF(n);
        }
    }
    set_error(msg);
    Py_XDECREF(type);
    Py_XDECREF(value);
    Py_XDECREF(tb);
}

/* RAII GIL holder for calls arriving from arbitrary native threads. */
struct Gil {
    PyGILState_STATE st;
    Gil() : st(PyGILState_Ensure()) {}
    ~Gil() { PyGILState_Release(st); }
};

std::once_flag g_init_once;
bool g_init_ok = false;
bool g_we_initialized = false;

/* Pure-Python marshalling helpers, exec'd once at init. Keeping the
 * numpy/padding logic in Python avoids linking numpy's C API. */
const char *kHelperSrc = R"PY(
import numpy as np

def load(path, dtype):
    import os
    from embeddings_tpu_torch.runtime.engine import load_model
    device = os.environ.get("EMBEDDINGS_TPU_TORCH_DEVICE") or "cuda"
    try:
        return load_model(path, dtype=dtype or "f32", device=device)
    except RuntimeError as exc:
        if "device" not in str(exc):
            raise
        raise RuntimeError(f"{exc} (device {device!r}: set "
                           f"EMBEDDINGS_TPU_TORCH_DEVICE to choose it, "
                           f"e.g. cpu)") from None

def encode_batch(engine, texts, batch_size):
    out = engine.encode_batch(list(texts), batch_size=int(batch_size))
    return np.ascontiguousarray(out, np.float32)

def forward_batch(engine, token_lists):
    # pad to the in-batch max (bert_forward_batch semantics,
    # reference bert.cpp:894-922); mask marks real tokens
    n = max(len(t) for t in token_lists)
    ids = np.full((len(token_lists), n), engine.tokenizer.pad_id, np.int32)
    mask = np.zeros((len(token_lists), n), np.int32)
    for i, t in enumerate(token_lists):
        ids[i, : len(t)] = t
        mask[i, : len(t)] = 1
    return np.ascontiguousarray(engine.forward(ids, mask), np.float32)

def tokenize(engine, text, n_max):
    ids = engine.tokenize(text)
    n_max = int(n_max)
    if 0 < n_max < len(ids):
        # truncate the body but keep the trailing [SEP] (the reference
        # truncates at n_max_tokens-1 the same way, bert.cpp:386)
        ids = ids[: n_max - 1] + [engine.tokenizer.sep_id]
    return ids

def id_to_token(engine, i):
    i = int(i)
    if i < 0:
        raise IndexError(i)
    return engine.tokenizer.id_to_token(i)
)PY";

PyObject *g_helpers = nullptr;  /* module dict of the helper namespace */

bool ensure_package_importable() {
    /* embeddings_tpu_torch must be importable; if not, add the repo root
     * it was built from to sys.path. */
    PyObject *mod = PyImport_ImportModule("embeddings_tpu_torch");
    if (mod) {
        Py_DECREF(mod);
        return true;
    }
    PyErr_Clear();
    std::string root = ET_REPO_ROOT;
    PyObject *sys_path = PySys_GetObject("path"); /* borrowed */
    PyObject *dir = PyUnicode_FromString(root.c_str());
    if (!sys_path || !dir) return false;
    PyList_Insert(sys_path, 0, dir);
    Py_DECREF(dir);
    mod = PyImport_ImportModule("embeddings_tpu_torch");
    if (!mod) return false;
    Py_DECREF(mod);
    return true;
}

/* Start the interpreter as the one that built this library, without
 * signal handlers (Py_InitializeEx(0)). */
bool start_interpreter() {
    PyConfig config;
    PyConfig_InitPythonConfig(&config);
    config.install_signal_handlers = 0;
#ifdef ET_PYTHON_EXECUTABLE
    PyStatus st = PyConfig_SetBytesString(&config, &config.program_name,
                                          ET_PYTHON_EXECUTABLE);
    if (!PyStatus_Exception(st)) st = Py_InitializeFromConfig(&config);
#else
    PyStatus st = Py_InitializeFromConfig(&config);
#endif
    PyConfig_Clear(&config);
    if (PyStatus_Exception(st)) {
        set_error(std::string("embedded interpreter failed to start: ") +
                  (st.err_msg ? st.err_msg : "unknown"));
        return false;
    }
    return true;
}

void init_interpreter() {
    if (!Py_IsInitialized()) {
        if (!start_interpreter()) return;
        g_we_initialized = true;
    }
    PyGILState_STATE st = PyGILState_Ensure();
    do {
        if (!ensure_package_importable()) {
            set_error_from_python();
            break;
        }
        PyObject *globals = PyDict_New();
        if (!globals) break;
        PyDict_SetItemString(globals, "__builtins__", PyEval_GetBuiltins());
        PyObject *res =
            PyRun_String(kHelperSrc, Py_file_input, globals, globals);
        if (!res) {
            set_error_from_python();
            Py_DECREF(globals);
            break;
        }
        Py_DECREF(res);
        g_helpers = globals;
        g_init_ok = true;
    } while (false);
    if (g_we_initialized) {
        /* Drop the GIL so future calls from any thread can take it. */
        PyGILState_Release(st);
        PyThreadState *ts = PyGILState_GetThisThreadState();
        if (ts && PyGILState_Check()) PyEval_SaveThread();
    } else {
        PyGILState_Release(st);
    }
}

bool ensure_init() {
    std::call_once(g_init_once, init_interpreter);
    if (!g_init_ok && g_error.empty())
        set_error("embedded interpreter failed to initialize");
    return g_init_ok;
}

PyObject *call_helper(const char *name, PyObject *args /* stolen */) {
    PyObject *fn = PyDict_GetItemString(g_helpers, name); /* borrowed */
    if (!fn) {
        Py_XDECREF(args);
        set_error(std::string("missing helper: ") + name);
        return nullptr;
    }
    PyObject *out = PyObject_CallObject(fn, args);
    Py_XDECREF(args);
    if (!out) set_error_from_python();
    return out;
}

/* Copy a C-contiguous float32 ndarray into dst; checks element count. */
bool copy_f32(PyObject *arr, float *dst, Py_ssize_t expect) {
    Py_buffer view;
    if (PyObject_GetBuffer(arr, &view, PyBUF_C_CONTIGUOUS) != 0) {
        set_error_from_python();
        return false;
    }
    bool ok = view.len == expect * (Py_ssize_t)sizeof(float);
    if (ok)
        std::memcpy(dst, view.buf, (size_t)view.len);
    else
        set_error("unexpected embedding buffer size");
    PyBuffer_Release(&view);
    return ok;
}

}  // namespace

struct et_ctx {
    PyObject *engine = nullptr;
    int32_t n_embd = 0;
    int32_t n_max_tokens = 0;
};

extern "C" {

ET_API const char *et_last_error(void) { return g_error.c_str(); }

ET_API et_ctx *et_load_from_file(const char *path, const char *dtype) {
    if (!path) {
        set_error("path is NULL");
        return nullptr;
    }
    if (!ensure_init()) return nullptr;
    Gil gil;
    PyObject *eng = call_helper(
        "load", Py_BuildValue("(ss)", path, dtype ? dtype : "f32"));
    if (!eng) return nullptr;
    et_ctx *ctx = new et_ctx();
    ctx->engine = eng;
    PyObject *v = PyObject_GetAttrString(eng, "n_embd");
    if (v) {
        ctx->n_embd = (int32_t)PyLong_AsLong(v);
        Py_DECREF(v);
    }
    v = PyObject_GetAttrString(eng, "max_seq_len");
    if (v) {
        ctx->n_max_tokens = (int32_t)PyLong_AsLong(v);
        Py_DECREF(v);
    }
    if (PyErr_Occurred()) {
        set_error_from_python();
        Py_DECREF(eng);
        delete ctx;
        return nullptr;
    }
    return ctx;
}

ET_API void et_free(et_ctx *ctx) {
    if (!ctx) return;
    {
        Gil gil;
        Py_XDECREF(ctx->engine);
    }
    delete ctx;
}

ET_API int32_t et_n_embd(et_ctx *ctx) { return ctx ? ctx->n_embd : 0; }

ET_API int32_t et_n_max_tokens(et_ctx *ctx) {
    return ctx ? ctx->n_max_tokens : 0;
}

ET_API int et_encode(et_ctx *ctx, const char *text, float *embeddings) {
    const char *t[1] = {text};
    float *e[1] = {embeddings};
    return et_encode_batch(ctx, 1, 1, t, e);
}

ET_API int et_encode_batch(et_ctx *ctx, int32_t n_batch_size,
                           int32_t n_inputs, const char **texts,
                           float **embeddings) {
    if (!ctx || !texts || !embeddings || n_inputs <= 0) {
        set_error("bad arguments");
        return -1;
    }
    Gil gil;
    PyObject *list = PyList_New(n_inputs);
    if (!list) {
        set_error_from_python();
        return -1;
    }
    for (int32_t i = 0; i < n_inputs; i++) {
        PyObject *s = PyUnicode_FromString(texts[i] ? texts[i] : "");
        if (!s) {
            set_error_from_python();
            Py_DECREF(list);
            return -1;
        }
        PyList_SET_ITEM(list, i, s);
    }
    PyObject *arr = call_helper(
        "encode_batch",
        Py_BuildValue("(ONi)", ctx->engine, list,
                      n_batch_size > 0 ? n_batch_size : n_inputs));
    if (!arr) return -1;
    /* copy row i into embeddings[i] */
    Py_buffer view;
    int rc = -1;
    if (PyObject_GetBuffer(arr, &view, PyBUF_C_CONTIGUOUS) == 0) {
        if (view.len == (Py_ssize_t)n_inputs * ctx->n_embd *
                            (Py_ssize_t)sizeof(float)) {
            const float *src = (const float *)view.buf;
            for (int32_t i = 0; i < n_inputs; i++)
                if (embeddings[i])
                    std::memcpy(embeddings[i], src + (size_t)i * ctx->n_embd,
                                sizeof(float) * ctx->n_embd);
            rc = 0;
        } else {
            set_error("unexpected embedding buffer size");
        }
        PyBuffer_Release(&view);
    } else {
        set_error_from_python();
    }
    Py_DECREF(arr);
    return rc;
}

ET_API int et_tokenize(et_ctx *ctx, const char *text, et_vocab_id *tokens,
                       int32_t *n_tokens, int32_t n_max_tokens) {
    if (!ctx || !text || !tokens || !n_tokens || n_max_tokens <= 0) {
        set_error("bad arguments");
        return -1;
    }
    Gil gil;
    PyObject *ids = call_helper(
        "tokenize", Py_BuildValue("(Osi)", ctx->engine, text, n_max_tokens));
    if (!ids) return -1;
    Py_ssize_t n = PyList_Size(ids);
    if (n > n_max_tokens) n = n_max_tokens;  // never write past the buffer
    for (Py_ssize_t i = 0; i < n; i++)
        tokens[i] = (et_vocab_id)PyLong_AsLong(PyList_GET_ITEM(ids, i));
    *n_tokens = (int32_t)n;
    Py_DECREF(ids);
    if (PyErr_Occurred()) {
        set_error_from_python();
        return -1;
    }
    return 0;
}

ET_API int et_forward(et_ctx *ctx, const et_vocab_id *tokens,
                      int32_t n_tokens, float *embeddings) {
    const et_vocab_id *bt[1] = {tokens};
    float *be[1] = {embeddings};
    return et_forward_batch(ctx, 1, bt, &n_tokens, be);
}

ET_API int et_forward_batch(et_ctx *ctx, int32_t n_batch,
                            const et_vocab_id *const *batch_tokens,
                            const int32_t *n_tokens,
                            float **batch_embeddings) {
    if (!ctx || !batch_tokens || !n_tokens || !batch_embeddings ||
        n_batch <= 0) {
        set_error("bad arguments");
        return -1;
    }
    Gil gil;
    PyObject *outer = PyList_New(n_batch);
    if (!outer) {
        set_error_from_python();
        return -1;
    }
    for (int32_t i = 0; i < n_batch; i++) {
        PyObject *inner = PyList_New(n_tokens[i]);
        if (!inner) {
            set_error_from_python();
            Py_DECREF(outer);
            return -1;
        }
        for (int32_t j = 0; j < n_tokens[i]; j++)
            PyList_SET_ITEM(inner, j, PyLong_FromLong(batch_tokens[i][j]));
        PyList_SET_ITEM(outer, i, inner);
    }
    PyObject *arr = call_helper(
        "forward_batch", Py_BuildValue("(ON)", ctx->engine, outer));
    if (!arr) return -1;
    int rc = 0;
    for (int32_t i = 0; i < n_batch && rc == 0; i++) {
        if (!batch_embeddings[i]) continue;  // tolerated like et_encode_batch
        PyObject *row = PySequence_GetItem(arr, i);
        if (!row || !copy_f32(row, batch_embeddings[i], ctx->n_embd)) rc = -1;
        Py_XDECREF(row);
    }
    Py_DECREF(arr);
    return rc;
}

ET_API int et_id_to_token(et_ctx *ctx, et_vocab_id id, char *buf,
                          int32_t buflen) {
    if (!ctx || !buf || buflen <= 0) {
        set_error("bad arguments");
        return -1;
    }
    Gil gil;
    PyObject *s =
        call_helper("id_to_token", Py_BuildValue("(Oi)", ctx->engine, id));
    if (!s) return -1;
    Py_ssize_t n = 0;
    const char *c = PyUnicode_AsUTF8AndSize(s, &n);
    int rc = -1;
    if (c && n < buflen) {
        std::memcpy(buf, c, (size_t)n);
        buf[n] = '\0';
        rc = (int)n;
    } else if (c) {
        set_error("token does not fit in buffer");
    } else {
        set_error_from_python();
    }
    Py_DECREF(s);
    return rc;
}

}  // extern "C"
