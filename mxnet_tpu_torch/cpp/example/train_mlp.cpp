// train_mlp.cpp — end-to-end training from the C++ frontend of the PyTorch
// port (counterpart of cpp/example/train_mlp.cpp; reference
// cpp-package/example/mlp.cpp): build a Symbol with Operator, SimpleBind
// an Executor, drive the SGD Optimizer per parameter, score with Accuracy,
// round-trip a checkpoint and serve the model through the Predictor. The
// data is the handwritten digits set the package carries
// (mxnet_tpu_torch/examples/data/digits.npz).
//
// Usage: train_mlp [--cpu] [--out DIR]
//   runs on the card, gpu(0), unless --cpu; writes its checkpoint and
//   bundle into DIR (default: the binary's directory).
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include "mxtpu_torch/mxtpu_torch.hpp"

using namespace mxtpu_torch;  // NOLINT

namespace {

Symbol BuildMLP() {
  Symbol data = Symbol::Variable("data");
  Symbol label = Symbol::Variable("softmax_label");
  Symbol fc1 = Operator("FullyConnected").SetParam("num_hidden", 64)(data).CreateSymbol("fc1");
  Symbol act1 =
      Operator("Activation").SetParam("act_type", "relu")(fc1).CreateSymbol("relu1");
  Symbol fc2 = Operator("FullyConnected").SetParam("num_hidden", 32)(act1).CreateSymbol("fc2");
  Symbol act2 =
      Operator("Activation").SetParam("act_type", "relu")(fc2).CreateSymbol("relu2");
  Symbol fc3 = Operator("FullyConnected").SetParam("num_hidden", 10)(act2).CreateSymbol("fc3");
  return Operator("SoftmaxOutput")
      .SetInput("data", fc3)
      .SetInput("label", label)
      .CreateSymbol("softmax");
}

// The 1797 x 64 digits, scaled to [0, 1], through the embedded interpreter.
void LoadDigits(std::vector<float>* X, std::vector<float>* y, size_t* n) {
  Obj common = Obj::Steal(PyImport_ImportModule("mxnet_tpu_torch.examples.common"),
                          "import mxnet_tpu_torch.examples.common");
  Obj ds = common.attr("load_digits")();
  Obj Xn = ds.attr("data").attr("astype")(to_py("float32")).attr("__truediv__")(to_py(16.0));
  Obj yn = ds.attr("target").attr("astype")(to_py("float32"));
  *X = bytes_to_vector(Xn);
  *y = bytes_to_vector(yn);
  *n = y->size();
}

// Copy trained weights into another executor bound to the same symbol.
void ShareWeights(const std::map<std::string, NDArray>& src, Executor* dst) {
  auto dargs = dst->arg_dict();
  for (const auto& kv : src)
    if (kv.first != "data" && kv.first != "softmax_label") kv.second.CopyTo(&dargs[kv.first]);
}

float Evaluate(Executor* exec, const NDArray& data, const NDArray& label) {
  auto args = exec->arg_dict();
  data.CopyTo(&args["data"]);
  exec->Forward(false);
  Accuracy acc;
  acc.Update(label, exec->outputs[0]);
  return acc.Get();
}

std::string DirOf(const std::string& path) {
  size_t slash = path.rfind('/');
  return slash == std::string::npos ? std::string(".") : path.substr(0, slash);
}

}  // namespace

int main(int argc, char** argv) {
  std::setvbuf(stdout, nullptr, _IOLBF, 0);  // progress visible in pipes
  bool cpu = false;
  std::string out = DirOf(argv[0]);
  for (int i = 1; i < argc; ++i) {
    if (std::string(argv[i]) == "--cpu") cpu = true;
    if (std::string(argv[i]) == "--out" && i + 1 < argc) out = argv[++i];
  }
  const int batch = 100;
  const int epochs = 40;
  Context ctx = cpu ? Context::cpu() : Context::gpu(0);
  SetDefaultContext(ctx);
  SeedEverything(7);  // deterministic init and shuffle for the gates

  Symbol net = BuildMLP();
  std::vector<float> X, y;
  size_t n = 0;
  LoadDigits(&X, &y, &n);
  const size_t train_n = 1500, dim = 64;
  const size_t val_n = n - train_n;
  NDArray train_x(X.data(), train_n * dim, Shape{train_n, dim}, ctx);
  NDArray train_y(y.data(), train_n, Shape{train_n}, ctx);
  NDArray val_x(X.data() + train_n * dim, val_n * dim, Shape{val_n, dim}, ctx);
  NDArray val_y(y.data() + train_n, val_n, Shape{val_n}, ctx);

  // the training executor at `batch`, the validation one at the whole set
  std::map<std::string, NDArray> args_map = {
      {"data", NDArray(Shape{(size_t)batch, dim}, ctx)},
      {"softmax_label", NDArray(Shape{(size_t)batch}, ctx)},
  };
  Executor* exec = net.SimpleBind(ctx, args_map);
  std::map<std::string, NDArray> val_args = {
      {"data", NDArray(Shape{val_n, dim}, ctx)},
      {"softmax_label", NDArray(Shape{val_n}, ctx)},
  };
  Executor* val_exec = net.SimpleBind(ctx, val_args, "null");

  Xavier xavier("gaussian", "in", 2.0);
  Zero zero;
  auto args = exec->arg_dict();
  for (auto& kv : args) {
    if (kv.first == "data" || kv.first == "softmax_label") continue;
    if (kv.first.find("bias") != std::string::npos)
      zero(kv.first, &kv.second);
    else
      xavier(kv.first, &kv.second);
  }

  Optimizer* opt = Optimizer::Find("sgd");
  opt->SetParam("learning_rate", 0.2)
      .SetParam("momentum", 0.9)
      .SetParam("wd", 1e-4)
      .SetParam("rescale_grad", 1.0 / batch);

  NDArrayIter train_iter(train_x, train_y, batch, /*shuffle=*/true);
  auto grads = exec->grad_dict();
  for (int epoch = 0; epoch < epochs; ++epoch) {
    train_iter.Reset();
    while (train_iter.Next()) {
      train_iter.GetData().CopyTo(&args["data"]);
      train_iter.GetLabel().CopyTo(&args["softmax_label"]);
      exec->Forward(true);
      exec->Backward();
      int index = 0;
      for (auto& kv : args) {
        if (kv.first == "data" || kv.first == "softmax_label") {
          ++index;
          continue;
        }
        opt->Update(index++, kv.second, grads[kv.first]);
      }
    }
    if ((epoch + 1) % 10 == 0) {
      ShareWeights(args, val_exec);
      std::printf("epoch %d val-accuracy: %.4f\n", epoch + 1, Evaluate(val_exec, val_x, val_y));
    }
  }

  ShareWeights(args, val_exec);
  float final_acc = Evaluate(val_exec, val_x, val_y);
  std::printf("final-accuracy: %.4f\n", final_acc);

  // checkpoint round trip through the dmlc-compatible .params container
  std::map<std::string, NDArray> to_save;
  for (auto& kv : args)
    if (kv.first != "data" && kv.first != "softmax_label") to_save["arg:" + kv.first] = kv.second;
  const std::string params = out + "/mxtpu_torch_cpp_mlp.params";
  const std::string symbol = out + "/mxtpu_torch_cpp_mlp-symbol.json";
  NDArray::Save(params, to_save);
  net.Save(symbol);
  Symbol net2 = Symbol::Load(symbol);
  Executor* reload_exec = net2.SimpleBind(ctx, val_args, "null");
  auto loaded = NDArray::LoadToMap(params);
  auto rargs = reload_exec->arg_dict();
  for (auto& kv : loaded) kv.second.CopyTo(&rargs[kv.first.substr(4)]);  // strip "arg:"
  float reload_acc = Evaluate(reload_exec, val_x, val_y);
  std::printf("reload-accuracy: %.4f\n", reload_acc);
  std::printf("checkpoint-roundtrip: %s\n", (reload_acc == final_acc) ? "exact" : "MISMATCH");

  // standalone inference through the Predictor (c_predict_api analog):
  // pack a one-file bundle, serve it, score in plain C++
  Obj pred_mod = Obj::Steal(PyImport_ImportModule("mxnet_tpu_torch.predict"),
                            "import mxnet_tpu_torch.predict");
  Obj pdict = Obj::Steal(PyDict_New(), "dict");
  for (auto& kv : args)
    if (kv.first != "data" && kv.first != "softmax_label")
      PyDict_SetItemString(pdict.get(), kv.first.c_str(), kv.second.py().get());
  const std::string bundle = out + "/mxtpu_torch_cpp_mlp.bundle";
  pred_mod.attr("export_bundle")(to_py(bundle), net.py(), pdict);
  Predictor pred = Predictor::FromBundle(bundle, {{"data", Shape{val_n, dim}}}, ctx);
  pred.SetInput("data", val_x.AsVector(), Shape{val_n, dim});
  pred.Forward();
  std::vector<float> probs = pred.GetOutput(0);
  std::vector<float> labels = val_y.AsVector();
  size_t n_classes = probs.size() / val_n, hits = 0;
  for (size_t i = 0; i < val_n; ++i) {
    size_t best = 0;
    for (size_t c = 1; c < n_classes; ++c)
      if (probs[i * n_classes + c] > probs[i * n_classes + best]) best = c;
    hits += (best == static_cast<size_t>(labels[i]));
  }
  float pred_acc = static_cast<float>(hits) / val_n;
  std::printf("predictor-accuracy: %.4f\n", pred_acc);
  std::printf("context: %s(%d)\n", ctx.dev_type().c_str(), ctx.dev_id());

  delete exec;
  delete val_exec;
  delete reload_exec;
  return (final_acc > 0.90f && reload_acc == final_acc && pred_acc == final_acc) ? 0 : 1;
}
