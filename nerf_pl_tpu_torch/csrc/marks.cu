// Phase marks for the profiler: one empty kernel per phase of the training
// step and of a frame, whose symbol names the phase in a device trace
// (`void nerf::mark<nerf::span::optimizer>()`), so a reader needs no table
// from the program. A mark is launched on the work's stream at the start of
// its phase: the device runs it when the phase's first operation can start,
// and a phase lasts until the next mark. nerf_pl_tpu_torch/utils/profiling.py
// launches them while a torch.profiler records, and captures them with the
// training step's CUDA graph. From that one capture come two executables:
// one with the marks (nerf_graph_split's), replayed while a profiler
// records, and one of the graph with its mark nodes taken out, which torch
// instantiates and replays otherwise. This source ports no TPU kernel.

#include <cuda_runtime.h>

#include <vector>

namespace nerf {
namespace span {
struct draws;
struct batch;
struct coarse_z;
struct occupied_z;
struct coarse;
struct fine_z;
struct fine;
struct backward;
struct allreduce;
struct optimizer;
struct tail;
struct end;
struct frame_pack;
struct frame_pad;
struct frame_gather;
struct frame_to_host;
struct cull;
struct bucket;
struct prop0;
struct resample1;
struct prop1;
struct resample2;
struct nerf;
struct losses;
struct clip;
}  // namespace span

template <class Tag>
__global__ void mark() {}

using MarkFn = void (*)();

// In the order of profiling.py's MARKS: a mark's index is its C id.
const MarkFn MARK_FNS[] = {
    mark<span::draws>,        mark<span::batch>,
    mark<span::coarse_z>,     mark<span::occupied_z>,
    mark<span::coarse>,       mark<span::fine_z>,
    mark<span::fine>,         mark<span::backward>,
    mark<span::allreduce>,    mark<span::optimizer>,
    mark<span::tail>,         mark<span::end>,
    mark<span::frame_pack>,   mark<span::frame_pad>,
    mark<span::frame_gather>, mark<span::frame_to_host>,
    mark<span::cull>,         mark<span::bucket>,
    mark<span::prop0>,        mark<span::resample1>,
    mark<span::prop1>,        mark<span::resample2>,
    mark<span::nerf>,         mark<span::losses>,
    mark<span::clip>,
};
constexpr int N_MARKS = static_cast<int>(sizeof(MARK_FNS) / sizeof(MarkFn));

// The graph API's entries in their CUDA 12 forms (no edge data: a capture
// makes plain edges).
cudaError_t capture_frontier(cudaStream_t s, cudaStreamCaptureStatus* status,
                             const cudaGraphNode_t** nodes, size_t* n) {
  return cudaStreamGetCaptureInfo(s, status, nullptr, nullptr, nodes, n);
}

cudaError_t node_deps(cudaGraphNode_t node, cudaGraphNode_t* out, size_t* n) {
  return cudaGraphNodeGetDependencies(node, out, n);
}

cudaError_t node_dependents(cudaGraphNode_t node, cudaGraphNode_t* out,
                            size_t* n) {
  return cudaGraphNodeGetDependentNodes(node, out, n);
}

cudaError_t add_edge(cudaGraph_t g, cudaGraphNode_t from, cudaGraphNode_t to) {
  return cudaGraphAddDependencies(g, &from, &to, 1);
}

cudaError_t node_list(cudaGraphNode_t node, bool deps,
                      std::vector<cudaGraphNode_t>* out) {
  size_t n = 0;
  cudaError_t err = deps ? node_deps(node, nullptr, &n)
                         : node_dependents(node, nullptr, &n);
  out->assign(n, nullptr);
  if (err || n == 0) return err;
  return deps ? node_deps(node, out->data(), &n)
              : node_dependents(node, out->data(), &n);
}

// Take `node` out of `g`, each of its dependencies now a dependency of each
// of its dependents, so the order of the rest stays as captured.
cudaError_t remove_node(cudaGraph_t g, cudaGraphNode_t node) {
  std::vector<cudaGraphNode_t> before, after, have;
  cudaError_t err = node_list(node, true, &before);
  if (!err) err = node_list(node, false, &after);
  for (size_t j = 0; !err && j < after.size(); ++j) {
    err = node_list(after[j], true, &have);
    for (size_t i = 0; !err && i < before.size(); ++i) {
      bool found = false;
      for (cudaGraphNode_t h : have) found = found || h == before[i];
      if (!found) err = add_edge(g, before[i], after[j]);
    }
  }
  return err ? err : cudaGraphDestroyNode(node);
}

}  // namespace nerf

extern "C" {

// Launch phase `phase`'s mark on `stream`. If the stream is being captured
// and `node` is not null, *node is the mark's node in the capture's graph
// (null otherwise).
int nerf_mark(int phase, void* stream, void* node) {
  if (phase < 0 || phase >= nerf::N_MARKS)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cudaLaunchKernel(reinterpret_cast<const void*>(nerf::MARK_FNS[phase]),
                       dim3(1), dim3(1), nullptr, 0, s);
  if (err || node == nullptr) return static_cast<int>(err);
  auto out = static_cast<cudaGraphNode_t*>(node);
  *out = nullptr;
  cudaStreamCaptureStatus status;
  const cudaGraphNode_t* frontier = nullptr;
  size_t n = 0;
  err = nerf::capture_frontier(s, &status, &frontier, &n);
  // the kernel just captured is the capture's one frontier node
  if (!err && status == cudaStreamCaptureStatusActive && n == 1)
    *out = frontier[0];
  return static_cast<int>(err);
}

// From `graph`, a captured graph that holds the `n` mark nodes `nodes`: its
// executable with the marks into *exec, then the marks taken out of the
// graph itself (its other nodes in their captured order).
int nerf_graph_split(void* graph, void* nodes, int n, void* exec) {
  auto g = static_cast<cudaGraph_t>(graph);
  auto marks = static_cast<cudaGraphNode_t*>(nodes);
  cudaGraphExec_t traced = nullptr;
  cudaError_t err = cudaGraphInstantiate(
      &traced, g, cudaGraphInstantiateFlagAutoFreeOnLaunch);
  for (int i = 0; !err && i < n; ++i) err = nerf::remove_node(g, marks[i]);
  if (err) {
    if (traced) cudaGraphExecDestroy(traced);
    return static_cast<int>(err);
  }
  *static_cast<cudaGraphExec_t*>(exec) = traced;
  return 0;
}

int nerf_graph_launch(void* exec, void* stream) {
  return static_cast<int>(cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec),
                                          static_cast<cudaStream_t>(stream)));
}

int nerf_graph_free(void* exec) {
  return static_cast<int>(
      cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec)));
}

}  // extern "C"
