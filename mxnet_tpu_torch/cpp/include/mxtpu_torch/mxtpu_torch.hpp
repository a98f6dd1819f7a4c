// mxtpu_torch.hpp — header-only C++ frontend for mxnet_tpu_torch, the
// PyTorch port (counterpart of cpp/include/mxtpu/mxtpu.hpp).
//
// The reference's cpp-package (cpp-package/include/mxnet-cpp/MxNetCpp.h:
// NDArray / Symbol / Operator / Executor / Optimizer / KVStore / DataIter /
// metric / initializer over the C ABI) layered C++ classes over
// libmxnet.so. The port's framework is a Python package over PyTorch and
// hand-written CUDA kernels, so this frontend embeds the CPython
// interpreter and drives mxnet_tpu_torch through the CPython C API: the
// arrays, the graphs and the kernels stay in the package, on the card or
// on the host, and this layer moves scalars, shapes and (on explicit Sync*
// calls) flat buffers.
//
// Design rules:
//  * header-only, C++17, no dependencies beyond <Python.h> (link with
//    `python3-config --embed --ldflags`).
//  * every class wraps exactly one Python object (RAII refcounting via
//    Obj).
//  * class and method names mirror the reference cpp-package API
//    (NDArray::SyncCopyFromCPU, Symbol::SimpleBind, Operator::SetParam
//    ..., reference cpp-package/include/mxnet-cpp/ndarray.h, symbol.h,
//    operator.h) so reference users can port call sites mechanically.
//  * Context::gpu(id) is the port's gpu(id), the CUDA card; Context::cpu()
//    the host. Runtime::SetDefaultContext makes one of them the context of
//    the arrays Python makes on its own (an iterator's batches).
#ifndef MXTPU_TORCH_CPP_MXTPU_TORCH_HPP_
#define MXTPU_TORCH_CPP_MXTPU_TORCH_HPP_

#include <Python.h>

#include <cstdint>
#include <cstring>
#include <initializer_list>
#include <map>
#include <sstream>
#include <stdexcept>
#include <string>
#include <utility>
#include <vector>

namespace mxtpu_torch {

using mx_float = float;

// ---------------------------------------------------------------------------
// Python error -> C++ exception
// ---------------------------------------------------------------------------
[[noreturn]] inline void ThrowPythonError(const std::string& where) {
  PyObject *ptype = nullptr, *pvalue = nullptr, *ptb = nullptr;
  PyErr_Fetch(&ptype, &pvalue, &ptb);
  PyErr_NormalizeException(&ptype, &pvalue, &ptb);
  std::string msg = where + ": unknown python error";
  if (pvalue != nullptr) {
    if (PyObject* s = PyObject_Str(pvalue)) {
      if (const char* c = PyUnicode_AsUTF8(s)) msg = where + ": " + c;
      Py_DECREF(s);
    }
  }
  Py_XDECREF(ptype);
  Py_XDECREF(pvalue);
  Py_XDECREF(ptb);
  throw std::runtime_error(msg);
}

// ---------------------------------------------------------------------------
// Obj — RAII PyObject* holder with call/attr helpers
// ---------------------------------------------------------------------------
class Obj {
 public:
  Obj() = default;
  // Take ownership of a NEW reference; nullptr raises the pending error.
  static Obj Steal(PyObject* p, const char* where = "call") {
    if (p == nullptr) ThrowPythonError(where);
    return Obj(p);
  }
  static Obj Borrow(PyObject* p) {
    Py_XINCREF(p);
    return Obj(p);
  }
  Obj(const Obj& o) : p_(o.p_) { Py_XINCREF(p_); }
  Obj(Obj&& o) noexcept : p_(o.p_) { o.p_ = nullptr; }
  Obj& operator=(Obj o) noexcept {
    std::swap(p_, o.p_);
    return *this;
  }
  ~Obj() {
    if (p_ != nullptr && Py_IsInitialized()) Py_DECREF(p_);
  }

  PyObject* get() const { return p_; }
  // Release ownership (for APIs that steal references, e.g. PyTuple_SetItem).
  PyObject* release() {
    PyObject* p = p_;
    p_ = nullptr;
    return p;
  }
  explicit operator bool() const { return p_ != nullptr && p_ != Py_None; }
  bool is_none() const { return p_ == nullptr || p_ == Py_None; }

  Obj attr(const char* name) const {
    if (p_ == nullptr)
      throw std::runtime_error(std::string("attr '") + name +
                               "' on empty handle (default-constructed or "
                               "moved-from wrapper)");
    return Steal(PyObject_GetAttrString(p_, name), name);
  }
  bool has_attr(const char* name) const {
    return PyObject_HasAttrString(p_, name) != 0;
  }
  void set_attr(const char* name, const Obj& v) const {
    if (PyObject_SetAttrString(p_, name, v.get()) != 0) ThrowPythonError(name);
  }

  // obj(args...) with already-converted Obj arguments.
  template <typename... A>
  Obj operator()(const A&... args) const {
    Obj t = Steal(PyTuple_New(sizeof...(A)), "tuple");
    int i = 0;
    // Braced-init-list evaluation packs the items left to right.
    (void)std::initializer_list<int>{
        (PyTuple_SetItem(t.get(), i++, copy_ref(args)), 0)...};
    return Steal(PyObject_Call(p_, t.get(), nullptr), "call");
  }
  Obj call_tuple(const Obj& args_tuple, const Obj& kwargs) const {
    return Steal(PyObject_Call(p_, args_tuple.get(), kwargs.get()), "call");
  }
  Obj call_tuple(const Obj& args_tuple) const {
    return Steal(PyObject_Call(p_, args_tuple.get(), nullptr), "call");
  }

  Obj item(Py_ssize_t i) const {  // sequence indexing
    return Steal(PySequence_GetItem(p_, i), "getitem");
  }
  Py_ssize_t size() const {
    Py_ssize_t n = PySequence_Size(p_);
    if (n < 0) ThrowPythonError("len");
    return n;
  }

  std::string str() const {
    Obj s = Steal(PyObject_Str(p_), "str");
    const char* c = PyUnicode_AsUTF8(s.get());
    if (c == nullptr) ThrowPythonError("str");
    return c;
  }

 private:
  explicit Obj(PyObject* p) : p_(p) {}
  static PyObject* copy_ref(const Obj& o) {
    PyObject* p = o.p_ != nullptr ? o.p_ : Py_None;
    Py_INCREF(p);
    return p;
  }
  PyObject* p_ = nullptr;
};

// ---------------------------------------------------------------------------
// C++ <-> Python scalar/sequence conversions
// ---------------------------------------------------------------------------
inline Obj to_py(long v) { return Obj::Steal(PyLong_FromLong(v), "int"); }
inline Obj to_py(int v) { return to_py(static_cast<long>(v)); }
inline Obj to_py(size_t v) {
  return Obj::Steal(PyLong_FromSize_t(v), "int");
}
inline Obj to_py(double v) { return Obj::Steal(PyFloat_FromDouble(v), "float"); }
inline Obj to_py(bool v) { return Obj::Borrow(v ? Py_True : Py_False); }
inline Obj to_py(const char* v) {
  return Obj::Steal(PyUnicode_FromString(v), "str");
}
inline Obj to_py(const std::string& v) { return to_py(v.c_str()); }
inline Obj to_py(const Obj& v) { return v; }

template <typename T>
inline Obj py_tuple_of(const std::vector<T>& v) {
  Obj t = Obj::Steal(PyTuple_New(static_cast<Py_ssize_t>(v.size())), "tuple");
  for (size_t i = 0; i < v.size(); ++i)
    PyTuple_SetItem(t.get(), static_cast<Py_ssize_t>(i), to_py(v[i]).release());
  return t;
}

inline long as_long(const Obj& o) {
  long v = PyLong_AsLong(o.get());
  if (v == -1 && PyErr_Occurred()) ThrowPythonError("as_long");
  return v;
}
inline double as_double(const Obj& o) {
  double v = PyFloat_AsDouble(o.get());
  if (v == -1.0 && PyErr_Occurred()) ThrowPythonError("as_double");
  return v;
}
inline std::string as_string(const Obj& o) {
  const char* c = PyUnicode_AsUTF8(o.get());
  if (c == nullptr) ThrowPythonError("as_string");
  return c;
}

// kwargs builder: KW("lr", 0.1)("momentum", 0.9).obj()
class KW {
 public:
  KW() : d_(Obj::Steal(PyDict_New(), "dict")) {}
  template <typename T>
  KW& operator()(const std::string& k, const T& v) {
    if (PyDict_SetItemString(d_.get(), k.c_str(), to_py(v).get()) != 0)
      ThrowPythonError(k);
    return *this;
  }
  const Obj& obj() const { return d_; }

 private:
  Obj d_;
};

// ---------------------------------------------------------------------------
// Runtime — embedded interpreter bootstrap (one per process)
// ---------------------------------------------------------------------------
class Runtime {
 public:
  static Runtime& Get() {
    static Runtime rt;
    return rt;
  }

  const Obj& mx() const { return mx_; }
  const Obj& np() const { return np_; }
  // getattr on the package root: Runtime::Get().mx_attr("nd")
  Obj mx_attr(const char* name) const { return mx_.attr(name); }

 private:
  Runtime() {
    if (!Py_IsInitialized()) {
      Py_InitializeEx(0);
      owns_interpreter_ = true;
    }
    mx_ = Obj::Steal(PyImport_ImportModule("mxnet_tpu_torch"),
                     "import mxnet_tpu_torch");
    np_ = Obj::Steal(PyImport_ImportModule("numpy"), "import numpy");
  }

  Obj mx_;
  Obj np_;
  bool owns_interpreter_ = false;
};

// Seed numpy + the framework RNG (deterministic examples and tests; the
// analog of mx.random.seed in the python convergence gates).
inline void SeedEverything(int seed) {
  Runtime::Get();  // ensure the interpreter + mxnet_tpu_torch are up
  std::ostringstream code;
  code << "import numpy as _np; _np.random.seed(" << seed << ")\n"
       << "import mxnet_tpu_torch as _mx; _mx.random.seed(" << seed << ")\n";
  if (PyRun_SimpleString(code.str().c_str()) != 0)
    ThrowPythonError("SeedEverything");
}

// ---------------------------------------------------------------------------
// Shape (reference: cpp-package/include/mxnet-cpp/shape.h)
// ---------------------------------------------------------------------------
class Shape {
 public:
  Shape() = default;
  Shape(std::initializer_list<size_t> dims) : dims_(dims) {}
  explicit Shape(std::vector<size_t> dims) : dims_(std::move(dims)) {}
  explicit Shape(const Obj& tuple) {
    for (Py_ssize_t i = 0; i < tuple.size(); ++i)
      dims_.push_back(static_cast<size_t>(as_long(tuple.item(i))));
  }

  size_t ndim() const { return dims_.size(); }
  size_t operator[](size_t i) const { return dims_[i]; }
  size_t Size() const {
    size_t n = 1;
    for (size_t d : dims_) n *= d;
    return n;
  }
  const std::vector<size_t>& data() const { return dims_; }
  bool operator==(const Shape& o) const { return dims_ == o.dims_; }
  bool operator!=(const Shape& o) const { return dims_ != o.dims_; }

  Obj py_tuple() const { return py_tuple_of(dims_); }
  std::string ToString() const {
    std::ostringstream os;
    os << '(';
    for (size_t i = 0; i < dims_.size(); ++i)
      os << (i ? "," : "") << dims_[i];
    os << ')';
    return os.str();
  }

 private:
  std::vector<size_t> dims_;
};

// Shared host-buffer bridges (one definition each — used by NDArray,
// Predictor and example code alike).
inline Obj np_array_from_buffer(const mx_float* data, size_t size,
                                const Shape& shape) {
  Obj bytes = Obj::Steal(
      PyBytes_FromStringAndSize(
          reinterpret_cast<const char*>(data),
          static_cast<Py_ssize_t>(size * sizeof(mx_float))),
      "bytes");
  Obj np = Runtime::Get().np();
  Obj flat = np.attr("frombuffer")(bytes, to_py("float32"));
  return flat.attr("reshape")(shape.py_tuple());
}

// array-like (NDArray.asnumpy() result or any numpy array) -> float32
// PyBytes, exposing the raw buffer. Keeps the bytes object alive via the
// returned Obj.
inline Obj as_f32_bytes(const Obj& array_like, char** src, Py_ssize_t* n) {
  Obj b = array_like.attr("astype")(to_py("float32")).attr("tobytes")();
  if (PyBytes_AsStringAndSize(b.get(), src, n) != 0)
    ThrowPythonError("tobytes");
  return b;
}

// Copy up to `size` float32 elements into `dest` (one memcpy straight
// out of the bytes object); returns the element count available.
inline size_t bytes_into_buffer(const Obj& array_like, mx_float* dest,
                                size_t size) {
  char* src = nullptr;
  Py_ssize_t n = 0;
  Obj keep = as_f32_bytes(array_like, &src, &n);
  size_t avail = static_cast<size_t>(n) / sizeof(mx_float);
  std::memcpy(dest, src, (avail < size ? avail : size) * sizeof(mx_float));
  return avail;
}

// Extract a full float32 copy into a C++ vector (single conversion).
inline std::vector<mx_float> bytes_to_vector(const Obj& array_like) {
  char* src = nullptr;
  Py_ssize_t n = 0;
  Obj keep = as_f32_bytes(array_like, &src, &n);
  std::vector<mx_float> v(static_cast<size_t>(n) / sizeof(mx_float));
  std::memcpy(v.data(), src, v.size() * sizeof(mx_float));
  return v;
}

// ---------------------------------------------------------------------------
// Context (reference: cpp-package/include/mxnet-cpp/base.h DeviceType)
// ---------------------------------------------------------------------------
class Context {
 public:
  static Context cpu(int id = 0) { return Context("cpu", id); }
  static Context gpu(int id = 0) { return Context("gpu", id); }

  const std::string& dev_type() const { return type_; }
  int dev_id() const { return id_; }

  Obj py() const {
    return Runtime::Get().mx().attr(type_.c_str())(mxtpu_torch::to_py(id_));
  }

 private:
  Context(std::string type, int id) : type_(std::move(type)), id_(id) {}
  std::string type_;
  int id_;
};

// The context of the arrays Python makes without being given one (an
// iterator's batches, an operator's outputs): the port's default is the
// card, gpu(0), so a host run sets cpu() here first. Enters the context
// in the interpreter for the rest of the program.
inline void SetDefaultContext(const Context& ctx) { ctx.py().attr("__enter__")(); }

// The port's kernel launch counters (mxnet_tpu_torch.ops.kernels: each
// wrapper counts the launches of its hand-written kernel), by wrapper.
inline std::map<std::string, long> KernelLaunches() {
  Obj k = Obj::Steal(PyImport_ImportModule("mxnet_tpu_torch.ops.kernels"),
                     "import mxnet_tpu_torch.ops.kernels");
  std::map<std::string, long> out;
  for (const char* name :
       {"conv_bwd_filter", "conv_bwd_input", "flash_attention",
        "flash_attention_dq", "flash_attention_dkv", "fused_slab_update"})
    out[name] = as_long(k.attr(name).attr("launches"));
  return out;
}

// ---------------------------------------------------------------------------
// NDArray (reference: cpp-package/include/mxnet-cpp/ndarray.h)
// ---------------------------------------------------------------------------
class NDArray {
 public:
  NDArray() = default;
  explicit NDArray(Obj handle) : h_(std::move(handle)) {}

  // Allocate zeros of `shape` on `ctx`.
  explicit NDArray(const Shape& shape, const Context& ctx = Context::cpu()) {
    h_ = nd_mod().attr("zeros")(shape.py_tuple(), ctx.py());
  }
  NDArray(const mx_float* data, size_t size, const Shape& shape,
          const Context& ctx = Context::cpu()) {
    h_ = from_buffer(data, size, shape, ctx);
  }
  NDArray(const std::vector<mx_float>& data, const Shape& shape,
          const Context& ctx = Context::cpu())
      : NDArray(data.data(), data.size(), shape, ctx) {}

  static NDArray Zeros(const Shape& s, const Context& ctx = Context::cpu()) {
    return NDArray(nd_mod().attr("zeros")(s.py_tuple(), ctx.py()));
  }
  static NDArray Ones(const Shape& s, const Context& ctx = Context::cpu()) {
    return NDArray(nd_mod().attr("ones")(s.py_tuple(), ctx.py()));
  }

  const Obj& py() const { return h_; }
  bool IsEmpty() const { return !h_; }

  // --- host <-> device buffer movement (explicit, like the reference) ---
  void SyncCopyFromCPU(const mx_float* data, size_t size) {
    Obj arr = np_array_from_buffer(data, size, GetShape());
    // a[:] = arr  (in-place rebind; python __setitem__ handles staging)
    set_all(arr);
  }
  void SyncCopyFromCPU(const std::vector<mx_float>& data) {
    SyncCopyFromCPU(data.data(), data.size());
  }
  void SyncCopyToCPU(mx_float* data, size_t size) const {
    size_t avail = bytes_into_buffer(h_.attr("asnumpy")(), data, size);
    if (avail < size)
      throw std::runtime_error("SyncCopyToCPU: array smaller than request");
  }
  std::vector<mx_float> AsVector() const {
    return bytes_to_vector(h_.attr("asnumpy")());
  }

  Shape GetShape() const { return Shape(h_.attr("shape")); }
  size_t Size() const { return GetShape().Size(); }
  std::string GetDType() const { return h_.attr("dtype").str(); }
  mx_float At(size_t index) const {
    Obj flat = h_.attr("asnumpy")().attr("ravel")();
    return static_cast<mx_float>(as_double(flat.item(index)));
  }

  NDArray Reshape(const Shape& s) const {
    return NDArray(h_.attr("reshape")(s.py_tuple()));
  }
  NDArray Slice(size_t begin, size_t end) const {
    return NDArray(h_.attr("slice")(mxtpu_torch::to_py(begin), mxtpu_torch::to_py(end)));
  }
  NDArray Copy(const Context& ctx) const {
    return NDArray(h_.attr("copyto")(ctx.py()));
  }
  void CopyTo(NDArray* dst) const { dst->set_all(h_); }

  NDArray ArgmaxChannel() const {
    return NDArray(nd_mod().attr("argmax")(h_, mxtpu_torch::to_py(1)));
  }

  void WaitToRead() const { h_.attr("wait_to_read")(); }
  static void WaitAll() { nd_mod().attr("waitall")(); }

  // --- arithmetic (python dunders dispatch into the package's ops) ---
  friend NDArray operator+(const NDArray& a, const NDArray& b) {
    return NDArray(Obj::Steal(PyNumber_Add(a.h_.get(), b.h_.get()), "+"));
  }
  friend NDArray operator-(const NDArray& a, const NDArray& b) {
    return NDArray(Obj::Steal(PyNumber_Subtract(a.h_.get(), b.h_.get()), "-"));
  }
  friend NDArray operator*(const NDArray& a, const NDArray& b) {
    return NDArray(Obj::Steal(PyNumber_Multiply(a.h_.get(), b.h_.get()), "*"));
  }
  friend NDArray operator/(const NDArray& a, const NDArray& b) {
    return NDArray(
        Obj::Steal(PyNumber_TrueDivide(a.h_.get(), b.h_.get()), "/"));
  }
  NDArray operator+(mx_float s) const {
    return NDArray(Obj::Steal(PyNumber_Add(h_.get(), mxtpu_torch::to_py(double(s)).get()), "+"));
  }
  NDArray operator-(mx_float s) const {
    return NDArray(
        Obj::Steal(PyNumber_Subtract(h_.get(), mxtpu_torch::to_py(double(s)).get()), "-"));
  }
  NDArray operator*(mx_float s) const {
    return NDArray(
        Obj::Steal(PyNumber_Multiply(h_.get(), mxtpu_torch::to_py(double(s)).get()), "*"));
  }
  NDArray operator/(mx_float s) const {
    return NDArray(
        Obj::Steal(PyNumber_TrueDivide(h_.get(), mxtpu_torch::to_py(double(s)).get()), "/"));
  }

  // --- checkpoint container (dmlc-compatible .params, see
  //     mxnet_tpu_torch/ndarray.py save/load) ---
  static void Save(const std::string& fname,
                   const std::map<std::string, NDArray>& arrays) {
    Obj d = Obj::Steal(PyDict_New(), "dict");
    for (const auto& kv : arrays)
      PyDict_SetItemString(d.get(), kv.first.c_str(), kv.second.py().get());
    nd_mod().attr("save")(mxtpu_torch::to_py(fname), d);
  }
  // Defined after ndarray_map_of below.
  static std::map<std::string, NDArray> LoadToMap(const std::string& fname);

  // internal: a[:] = value
  void set_all(const Obj& value) {
    Obj slice = Obj::Steal(PySlice_New(nullptr, nullptr, nullptr), "slice");
    if (PyObject_SetItem(h_.get(), slice.get(), value.get()) != 0)
      ThrowPythonError("setitem");
  }

 private:
  static Obj nd_mod() { return Runtime::Get().mx_attr("nd"); }

  static Obj from_buffer(const mx_float* data, size_t size, const Shape& shape,
                         const Context& ctx) {
    Obj arr = np_array_from_buffer(data, size, shape);
    Obj kw = KW()("ctx", ctx.py()).obj();
    Obj t = Obj::Steal(PyTuple_New(1), "tuple");
    PyTuple_SetItem(t.get(), 0, to_py(arr).release());
    return nd_mod().attr("array").call_tuple(t, kw);
  }

  Obj h_;
};

// Shared python-dict(name -> NDArray) to std::map conversion (used by the
// checkpoint loader and the Executor arg/grad/aux dictionaries).
inline std::map<std::string, NDArray> ndarray_map_of(const Obj& dict_like,
                                                     const char* where) {
  std::map<std::string, NDArray> out;
  Obj items = dict_like.attr("items")();
  Obj it = Obj::Steal(PyObject_GetIter(items.get()), "iter");
  while (PyObject* raw = PyIter_Next(it.get())) {
    Obj pair = Obj::Steal(raw, "pair");
    out[as_string(pair.item(0))] = NDArray(pair.item(1));
  }
  if (PyErr_Occurred()) ThrowPythonError(where);
  return out;
}

inline std::map<std::string, NDArray> NDArray::LoadToMap(
    const std::string& fname) {
  return ndarray_map_of(nd_mod().attr("load")(mxtpu_torch::to_py(fname)),
                        "LoadToMap");
}

// ---------------------------------------------------------------------------
// Symbol (reference: cpp-package/include/mxnet-cpp/symbol.h)
// ---------------------------------------------------------------------------
class Executor;  // fwd

class Symbol {
 public:
  Symbol() = default;
  explicit Symbol(Obj handle) : h_(std::move(handle)) {}

  static Symbol Variable(const std::string& name) {
    return Symbol(sym_mod().attr("Variable")(to_py(name)));
  }
  static Symbol Group(const std::vector<Symbol>& parts) {
    Obj lst = Obj::Steal(PyList_New(static_cast<Py_ssize_t>(parts.size())),
                         "list");
    for (size_t i = 0; i < parts.size(); ++i)
      PyList_SetItem(lst.get(), static_cast<Py_ssize_t>(i),
                     to_py(parts[i].py()).release());
    return Symbol(sym_mod().attr("Group")(lst));
  }
  static Symbol Load(const std::string& fname) {
    return Symbol(sym_mod().attr("load")(to_py(fname)));
  }
  static Symbol LoadJSON(const std::string& json) {
    return Symbol(sym_mod().attr("load_json")(to_py(json)));
  }

  const Obj& py() const { return h_; }
  void Save(const std::string& fname) const { h_.attr("save")(mxtpu_torch::to_py(fname)); }
  std::string ToJSON() const { return as_string(h_.attr("tojson")()); }
  std::string name() const { return as_string(h_.attr("name")); }

  Symbol operator[](int index) const {
    return Symbol(Obj::Steal(
        PySequence_GetItem(h_.get(), static_cast<Py_ssize_t>(index)), "[]"));
  }

  std::vector<std::string> ListArguments() const {
    return str_list(h_.attr("list_arguments")());
  }
  std::vector<std::string> ListOutputs() const {
    return str_list(h_.attr("list_outputs")());
  }
  std::vector<std::string> ListAuxiliaryStates() const {
    return str_list(h_.attr("list_auxiliary_states")());
  }

  friend Symbol operator+(const Symbol& a, const Symbol& b) {
    return Symbol(Obj::Steal(PyNumber_Add(a.h_.get(), b.h_.get()), "+"));
  }
  friend Symbol operator-(const Symbol& a, const Symbol& b) {
    return Symbol(Obj::Steal(PyNumber_Subtract(a.h_.get(), b.h_.get()), "-"));
  }
  friend Symbol operator*(const Symbol& a, const Symbol& b) {
    return Symbol(Obj::Steal(PyNumber_Multiply(a.h_.get(), b.h_.get()), "*"));
  }
  Symbol operator*(mx_float s) const {
    return Symbol(
        Obj::Steal(PyNumber_Multiply(h_.get(), mxtpu_torch::to_py(double(s)).get()), "*"));
  }
  Symbol operator+(mx_float s) const {
    return Symbol(Obj::Steal(PyNumber_Add(h_.get(), mxtpu_torch::to_py(double(s)).get()), "+"));
  }

  // infer_shape from named input shapes; fills arg/out/aux shape vectors.
  void InferShape(const std::map<std::string, Shape>& input_shapes,
                  std::vector<Shape>* arg_shapes,
                  std::vector<Shape>* out_shapes,
                  std::vector<Shape>* aux_shapes) const {
    KW kw;
    for (const auto& kv : input_shapes) kw(kv.first, kv.second.py_tuple());
    Obj res = h_.attr("infer_shape")
                  .call_tuple(Obj::Steal(PyTuple_New(0), "t"), kw.obj());
    auto fill = [&res](int idx, std::vector<Shape>* out) {
      if (out == nullptr) return;
      out->clear();
      Obj lst = res.item(idx);
      if (lst.is_none()) return;
      for (Py_ssize_t i = 0; i < lst.size(); ++i)
        out->push_back(Shape(lst.item(i)));
    };
    fill(0, arg_shapes);
    fill(1, out_shapes);
    fill(2, aux_shapes);
  }

  // Defined after Executor.
  inline Executor* SimpleBind(
      const Context& ctx, const std::map<std::string, NDArray>& args_map,
      const std::string& grad_req = "write",
      const std::map<std::string, NDArray>& aux_map = {});
  inline Executor* Bind(const Context& ctx,
                        const std::map<std::string, NDArray>& args,
                        const std::map<std::string, NDArray>& args_grad,
                        const std::string& grad_req = "write",
                        const std::map<std::string, NDArray>& aux = {});

 private:
  static Obj sym_mod() { return Runtime::Get().mx_attr("sym"); }
  static std::vector<std::string> str_list(const Obj& lst) {
    std::vector<std::string> out;
    for (Py_ssize_t i = 0; i < lst.size(); ++i)
      out.push_back(as_string(lst.item(i)));
    return out;
  }

  Obj h_;
};

// ---------------------------------------------------------------------------
// Operator — generic op construction, symbolic AND imperative
// (reference: cpp-package/include/mxnet-cpp/operator.h; there the op
// table comes from MXSymbolListAtomicSymbolCreators, here from the
// python registry — same late-bound design, no generated op headers.)
// ---------------------------------------------------------------------------
class Operator {
 public:
  explicit Operator(const std::string& op_name) : op_(op_name) {}

  template <typename T>
  Operator& SetParam(const std::string& key, const T& value) {
    params_(key, value);
    return *this;
  }
  Operator& SetParam(const std::string& key, const Shape& value) {
    params_(key, value.py_tuple());
    return *this;
  }

  Operator& SetInput(const std::string& name, const Symbol& s) {
    params_(name, s.py());
    return *this;
  }
  Operator& PushInput(const Symbol& s) {
    sym_inputs_.push_back(s);
    return *this;
  }
  Operator& operator()(const Symbol& s) { return PushInput(s); }

  Operator& SetInput(const std::string& name, const NDArray& nd) {
    params_(name, nd.py());
    return *this;
  }
  Operator& PushInput(const NDArray& nd) {
    nd_inputs_.push_back(nd);
    return *this;
  }
  Operator& operator()(const NDArray& nd) { return PushInput(nd); }

  // Build a Symbol node (symbolic API).
  Symbol CreateSymbol(const std::string& name = "") {
    if (!name.empty()) params_("name", name);
    Obj fn = Runtime::Get().mx_attr("sym").attr(op_.c_str());
    Obj t = Obj::Steal(
        PyTuple_New(static_cast<Py_ssize_t>(sym_inputs_.size())), "tuple");
    for (size_t i = 0; i < sym_inputs_.size(); ++i)
      PyTuple_SetItem(t.get(), static_cast<Py_ssize_t>(i),
                      to_py(sym_inputs_[i].py()).release());
    return Symbol(fn.call_tuple(t, params_.obj()));
  }

  // Imperative invoke (reference Operator::Invoke — MXImperativeInvoke).
  NDArray Invoke() {
    Obj fn = Runtime::Get().mx_attr("nd").attr(op_.c_str());
    Obj t = Obj::Steal(
        PyTuple_New(static_cast<Py_ssize_t>(nd_inputs_.size())), "tuple");
    for (size_t i = 0; i < nd_inputs_.size(); ++i)
      PyTuple_SetItem(t.get(), static_cast<Py_ssize_t>(i),
                      to_py(nd_inputs_[i].py()).release());
    Obj res = fn.call_tuple(t, params_.obj());
    if (PySequence_Check(res.get()) != 0 &&
        PyObject_HasAttrString(res.get(), "asnumpy") == 0)
      return NDArray(res.item(0));
    return NDArray(res);
  }
  void Invoke(NDArray& output) { output = Invoke(); }  // NOLINT

 private:
  std::string op_;
  KW params_;
  std::vector<Symbol> sym_inputs_;
  std::vector<NDArray> nd_inputs_;
};

// ---------------------------------------------------------------------------
// Executor (reference: cpp-package/include/mxnet-cpp/executor.h)
// ---------------------------------------------------------------------------
class Executor {
 public:
  explicit Executor(Obj handle) : h_(std::move(handle)) {}

  void Forward(bool is_train) {
    Obj kw = KW()("is_train", is_train).obj();
    h_.attr("forward").call_tuple(Obj::Steal(PyTuple_New(0), "t"), kw);
    // Refresh the outputs on the inference path only, as the JAX
    // frontend does: Backward() refreshes them for the training path and
    // Outputs() reads them on demand in between. Clearing prevents a stale
    // previous-step read through the public member.
    if (is_train)
      outputs.clear();
    else
      RefreshOutputs();
  }
  void Backward(const std::vector<NDArray>& head_grads = {}) {
    if (head_grads.empty()) {
      h_.attr("backward")();
    } else {
      Obj lst = Obj::Steal(
          PyList_New(static_cast<Py_ssize_t>(head_grads.size())), "list");
      for (size_t i = 0; i < head_grads.size(); ++i)
        PyList_SetItem(lst.get(), static_cast<Py_ssize_t>(i),
                       to_py(head_grads[i].py()).release());
      h_.attr("backward")(lst);
    }
    RefreshOutputs();
  }

  std::map<std::string, NDArray> arg_dict() const {
    return ndarray_map_of(h_.attr("arg_dict"), "arg_dict");
  }
  std::map<std::string, NDArray> grad_dict() const {
    return ndarray_map_of(h_.attr("grad_dict"), "grad_dict");
  }
  std::map<std::string, NDArray> aux_dict() const {
    return ndarray_map_of(h_.attr("aux_dict"), "aux_dict");
  }

  const Obj& py() const { return h_; }

  // On-demand outputs: always valid, also right after Forward(true).
  const std::vector<NDArray>& Outputs() {
    if (outputs.empty()) RefreshOutputs();
    return outputs;
  }

  // Valid after Forward(false), Backward(), or Outputs(); empty right
  // after Forward(true) (use Outputs() there). Mirrors the reference's
  // public member, executor.h.
  std::vector<NDArray> outputs;

 private:
  void RefreshOutputs() {
    outputs.clear();
    Obj outs = h_.attr("outputs");
    for (Py_ssize_t i = 0; i < outs.size(); ++i)
      outputs.push_back(NDArray(outs.item(i)));
  }

  Obj h_;
};

inline Executor* Symbol::SimpleBind(
    const Context& ctx, const std::map<std::string, NDArray>& args_map,
    const std::string& grad_req,
    const std::map<std::string, NDArray>& aux_map) {
  // Infer shapes from the provided arrays, let python simple_bind
  // allocate executor storage, then copy the provided values in (the
  // reference's SimpleBind has the same copy-in contract).
  KW kw;
  kw("ctx", ctx.py())("grad_req", grad_req);
  for (const auto& kv : args_map) kw(kv.first, kv.second.GetShape().py_tuple());
  Obj ex = h_.attr("simple_bind")
               .call_tuple(Obj::Steal(PyTuple_New(0), "t"), kw.obj());
  auto* exec = new Executor(ex);
  auto args = exec->arg_dict();
  for (const auto& kv : args_map) {
    auto it = args.find(kv.first);
    if (it != args.end()) kv.second.CopyTo(&it->second);
  }
  auto aux = exec->aux_dict();
  for (const auto& kv : aux_map) {
    auto it = aux.find(kv.first);
    if (it != aux.end()) kv.second.CopyTo(&it->second);
  }
  return exec;
}

inline Executor* Symbol::Bind(const Context& ctx,
                              const std::map<std::string, NDArray>& args,
                              const std::map<std::string, NDArray>& args_grad,
                              const std::string& grad_req,
                              const std::map<std::string, NDArray>& aux) {
  auto dict = [](const std::map<std::string, NDArray>& m) {
    Obj d = Obj::Steal(PyDict_New(), "dict");
    for (const auto& kv : m)
      PyDict_SetItemString(d.get(), kv.first.c_str(), kv.second.py().get());
    return d;
  };
  KW kw;
  kw("args", dict(args))("grad_req", grad_req);
  if (!args_grad.empty()) kw("args_grad", dict(args_grad));
  if (!aux.empty()) kw("aux_states", dict(aux));
  Obj t = Obj::Steal(PyTuple_New(1), "tuple");
  PyTuple_SetItem(t.get(), 0, to_py(ctx.py()).release());
  Obj ex = h_.attr("bind").call_tuple(t, kw.obj());
  return new Executor(ex);
}

// ---------------------------------------------------------------------------
// Optimizer (reference: cpp-package/include/mxnet-cpp/optimizer.h —
// OptimizerRegistry::Find("sgd") + SetParam + Update(index, w, g))
// ---------------------------------------------------------------------------
class Optimizer {
 public:
  explicit Optimizer(const std::string& type) : type_(type) {}
  static Optimizer* Find(const std::string& type) { return new Optimizer(type); }

  template <typename T>
  Optimizer& SetParam(const std::string& key, const T& value) {
    if (built_) throw std::runtime_error("Optimizer: SetParam after Update");
    params_(key, value);
    return *this;
  }

  void Update(int index, NDArray& weight, const NDArray& grad) {  // NOLINT
    EnsureBuilt();
    updater_(to_py(index), grad.py(), weight.py());
  }

  // The python Optimizer object (for KVStore::SetOptimizer).
  Obj py_optimizer() {
    EnsureBuilt();
    return opt_;
  }

 private:
  void EnsureBuilt() {
    if (built_) return;
    Obj mod = Runtime::Get().mx_attr("optimizer");
    Obj t = Obj::Steal(PyTuple_New(1), "tuple");
    PyTuple_SetItem(t.get(), 0, to_py(type_).release());
    opt_ = mod.attr("create").call_tuple(t, params_.obj());
    updater_ = mod.attr("get_updater")(opt_);
    built_ = true;
  }

  std::string type_;
  KW params_;
  Obj opt_, updater_;
  bool built_ = false;
};

// ---------------------------------------------------------------------------
// KVStore (reference: cpp-package/include/mxnet-cpp/kvstore.h)
// ---------------------------------------------------------------------------
class KVStore {
 public:
  explicit KVStore(const std::string& type = "local") {
    kv_ = Runtime::Get().mx_attr("kvstore").attr("create")(to_py(type));
  }

  void Init(int key, const NDArray& value) {
    kv_.attr("init")(to_py(key), value.py());
  }
  void Push(int key, const NDArray& value, int priority = 0) {
    Obj kw = KW()("priority", priority).obj();
    Obj t = Obj::Steal(PyTuple_New(2), "tuple");
    PyTuple_SetItem(t.get(), 0, to_py(key).release());
    PyTuple_SetItem(t.get(), 1, to_py(value.py()).release());
    kv_.attr("push").call_tuple(t, kw);
  }
  void Pull(int key, NDArray* out, int priority = 0) {
    Obj kw = KW()("out", out->py())("priority", priority).obj();
    Obj t = Obj::Steal(PyTuple_New(1), "tuple");
    PyTuple_SetItem(t.get(), 0, to_py(key).release());
    kv_.attr("pull").call_tuple(t, kw);
  }
  void SetOptimizer(Optimizer* opt) {
    kv_.attr("set_optimizer")(opt->py_optimizer());
  }

  std::string GetType() const { return as_string(kv_.attr("type")); }
  int GetRank() const { return static_cast<int>(as_long(kv_.attr("rank"))); }
  int GetNumWorkers() const {
    return static_cast<int>(as_long(kv_.attr("num_workers")));
  }
  void Barrier() const { kv_.attr("_barrier")(); }

 private:
  Obj kv_;
};

// ---------------------------------------------------------------------------
// Data iterators (reference: cpp-package/include/mxnet-cpp/io.h MXDataIter)
// ---------------------------------------------------------------------------
class DataIter {
 public:
  DataIter() = default;
  explicit DataIter(Obj it) : it_(std::move(it)) {}

  void Reset() {
    batch_ = Obj();
    it_.attr("reset")();
  }
  void BeforeFirst() { Reset(); }

  bool Next() {
    Obj next = it_.attr("next");
    PyObject* raw = PyObject_CallNoArgs(next.get());
    if (raw == nullptr) {
      if (PyErr_ExceptionMatches(PyExc_StopIteration)) {
        PyErr_Clear();
        return false;
      }
      ThrowPythonError("DataIter.next");
    }
    batch_ = Obj::Steal(raw, "batch");
    return true;
  }

  NDArray GetData() const { return NDArray(batch_.attr("data").item(0)); }
  NDArray GetLabel() const { return NDArray(batch_.attr("label").item(0)); }
  int GetPadNum() const {
    Obj pad = batch_.attr("pad");
    return pad.is_none() ? 0 : static_cast<int>(as_long(pad));
  }

  const Obj& py() const { return it_; }

 protected:
  Obj it_;
  Obj batch_;
};

// Late-bound named-iterator factory, mirroring
// MXDataIter("MNISTIter").SetParam(...).CreateDataIter().
class MXDataIter : public DataIter {
 public:
  explicit MXDataIter(const std::string& iter_name) : name_(iter_name) {}

  template <typename T>
  MXDataIter& SetParam(const std::string& key, const T& value) {
    params_(key, value);
    return *this;
  }

  MXDataIter& CreateDataIter() {
    Obj cls = Runtime::Get().mx_attr("io").attr(name_.c_str());
    it_ = cls.call_tuple(Obj::Steal(PyTuple_New(0), "t"), params_.obj());
    return *this;
  }

 private:
  std::string name_;
  KW params_;
};

// In-memory iterator over C++ buffers (reference NDArrayIter analog).
class NDArrayIter : public DataIter {
 public:
  NDArrayIter(const NDArray& data, const NDArray& label, int batch_size,
              bool shuffle = false) {
    Obj kw = KW()("data", data.py().attr("asnumpy")())(
                 "label", label.py().attr("asnumpy")())(
                 "batch_size", batch_size)("shuffle", shuffle)
                 .obj();
    it_ = Runtime::Get()
              .mx_attr("io")
              .attr("NDArrayIter")
              .call_tuple(Obj::Steal(PyTuple_New(0), "t"), kw);
  }
};

// ---------------------------------------------------------------------------
// Metrics (reference: cpp-package/include/mxnet-cpp/metric.h)
// ---------------------------------------------------------------------------
class EvalMetric {
 public:
  explicit EvalMetric(const std::string& name) {
    m_ = Runtime::Get().mx_attr("metric").attr("create")(to_py(name));
  }
  void Reset() { m_.attr("reset")(); }
  void Update(const NDArray& label, const NDArray& pred) {
    Obj labels = Obj::Steal(PyList_New(1), "list");
    PyList_SetItem(labels.get(), 0, to_py(label.py()).release());
    Obj preds = Obj::Steal(PyList_New(1), "list");
    PyList_SetItem(preds.get(), 0, to_py(pred.py()).release());
    m_.attr("update")(labels, preds);
  }
  float Get() const {
    Obj res = m_.attr("get")();
    return static_cast<float>(as_double(res.item(1)));
  }

 private:
  Obj m_;
};

class Accuracy : public EvalMetric {
 public:
  Accuracy() : EvalMetric("accuracy") {}
};

// ---------------------------------------------------------------------------
// Initializers (reference: cpp-package/include/mxnet-cpp/initializer.h)
// ---------------------------------------------------------------------------
class Initializer {
 public:
  void operator()(const std::string& name, NDArray* arr) const {
    init_(to_py(name), arr->py());
  }

 protected:
  explicit Initializer(Obj init) : init_(std::move(init)) {}
  static Obj init_mod() { return Runtime::Get().mx_attr("init"); }
  Obj init_;
};

class Xavier : public Initializer {
 public:
  explicit Xavier(const std::string& rnd_type = "uniform",
                  const std::string& factor_type = "avg",
                  double magnitude = 3.0)
      : Initializer(init_mod().attr("Xavier").call_tuple(
            Obj::Steal(PyTuple_New(0), "t"),
            KW()("rnd_type", rnd_type)("factor_type", factor_type)(
                "magnitude", magnitude)
                .obj())) {}
};

class Uniform : public Initializer {
 public:
  explicit Uniform(double scale = 0.07)
      : Initializer(init_mod().attr("Uniform")(to_py(scale))) {}
};

class Normal : public Initializer {
 public:
  explicit Normal(double sigma = 0.01)
      : Initializer(init_mod().attr("Normal")(to_py(sigma))) {}
};

class Zero : public Initializer {
 public:
  Zero() : Initializer(init_mod().attr("Zero")()) {}
};

// ---------------------------------------------------------------------------
// Predictor — standalone inference (reference: include/mxnet/
// c_predict_api.h MXPredCreate/SetInput/Forward/GetOutput and the
// amalgamation packaging; here over mxnet_tpu_torch.predict.Predictor /
// load_bundle, the single-file deployment analog)
// ---------------------------------------------------------------------------
class Predictor {
 public:
  // MXPredCreate: symbol JSON + serialized params (mx.nd.save bytes).
  Predictor(const std::string& symbol_json, const std::string& param_bytes,
            const std::map<std::string, Shape>& input_shapes,
            const Context& ctx = Context::cpu()) {
    Obj shapes = shape_dict(input_shapes);
    Obj params = Obj::Steal(
        PyBytes_FromStringAndSize(param_bytes.data(),
                                  static_cast<Py_ssize_t>(param_bytes.size())),
        "bytes");
    h_ = mod().attr("Predictor")(to_py(symbol_json), params, shapes,
                                 ctx.py());
  }

  // Load an export_bundle file (the amalgamation single-file analog).
  static Predictor FromBundle(
      const std::string& path,
      const std::map<std::string, Shape>& input_shapes,
      const Context& ctx = Context::cpu()) {
    return Predictor(mod().attr("load_bundle")(
        to_py(path), shape_dict(input_shapes), ctx.py()));
  }

  void SetInput(const std::string& name, const mx_float* data,
                const Shape& shape) {
    // hand python a host numpy array directly: routing through a device
    // NDArray would round-trip host->device->host->device because
    // set_input stages via np.asarray
    h_.attr("set_input")(to_py(name),
                         np_array_from_buffer(data, shape.Size(), shape));
  }
  void SetInput(const std::string& name, const std::vector<mx_float>& data,
                const Shape& shape) {
    SetInput(name, data.data(), shape);
  }

  void Forward() { h_.attr("forward")(); }

  std::vector<mx_float> GetOutput(int index = 0) {
    return bytes_to_vector(h_.attr("get_output")(to_py(index)));
  }

  Shape GetOutputShape(int index = 0) {
    Obj out = h_.attr("get_output")(to_py(index));
    return Shape(out.attr("shape"));
  }

  // MXPredReshape: rebind on new input shapes keeping weights.
  void Reshape(const std::map<std::string, Shape>& input_shapes) {
    h_.attr("reshape")(shape_dict(input_shapes));
  }

 private:
  explicit Predictor(Obj h) : h_(std::move(h)) {}
  static Obj mod() {
    return Obj::Steal(PyImport_ImportModule("mxnet_tpu_torch.predict"),
                      "import mxnet_tpu_torch.predict");
  }
  static Obj shape_dict(const std::map<std::string, Shape>& shapes) {
    Obj d = Obj::Steal(PyDict_New(), "dict");
    for (const auto& kv : shapes)
      PyDict_SetItemString(d.get(), kv.first.c_str(),
                           kv.second.py_tuple().get());
    return d;
  }

  Obj h_;
};

}  // namespace mxtpu_torch

#endif  // MXTPU_TORCH_CPP_MXTPU_TORCH_HPP_
