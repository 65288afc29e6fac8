// Core runtime types for the TPU-native collective framework.
//
// Capability parity with the reference's common.h:105-251 (Status,
// TensorShape, Request/Response wire types, enums), re-designed for a
// runtime whose device plane is XLA: tensors are identified by name +
// metadata only; device buffers never cross this layer (the XLA executor
// owns them), while host buffers may ride the native data plane.

// Thread posture (thread_annotations.h has the checked vocabulary):
// everything in this header is a VALUE type — Status, TensorShape,
// Request/Response, TensorTableEntry own their data and are confined to
// one thread at a time (handed off by move through internally-locked
// containers like TensorQueue). Nothing here carries a capability.
//
#ifndef HVD_COMMON_H_
#define HVD_COMMON_H_

#include <cstdint>
#include <functional>
#include <string>
#include <vector>

namespace hvd {

// ---- status ---------------------------------------------------------------

enum class StatusType : int {
  OK = 0,
  UNKNOWN_ERROR = 1,
  PRECONDITION_ERROR = 2,
  ABORTED = 3,
  INVALID_ARGUMENT = 4,
  IN_PROGRESS = 5,
};

class Status {
 public:
  Status() = default;
  static Status OK() { return Status(); }
  static Status Error(StatusType t, std::string msg) {
    Status s; s.type_ = t; s.reason_ = std::move(msg); return s;
  }
  static Status Aborted(std::string msg) {
    return Error(StatusType::ABORTED, std::move(msg));
  }
  static Status InvalidArgument(std::string msg) {
    return Error(StatusType::INVALID_ARGUMENT, std::move(msg));
  }
  static Status PreconditionError(std::string msg) {
    return Error(StatusType::PRECONDITION_ERROR, std::move(msg));
  }
  static Status InProgress() {
    Status s; s.type_ = StatusType::IN_PROGRESS; return s;
  }
  bool ok() const { return type_ == StatusType::OK; }
  bool in_progress() const { return type_ == StatusType::IN_PROGRESS; }
  StatusType type() const { return type_; }
  const std::string& reason() const { return reason_; }

 private:
  StatusType type_ = StatusType::OK;
  std::string reason_;
};

// ---- dtypes ---------------------------------------------------------------

enum class DataType : int {
  HVD_UINT8 = 0,
  HVD_INT8 = 1,
  HVD_UINT16 = 2,
  HVD_INT16 = 3,
  HVD_INT32 = 4,
  HVD_INT64 = 5,
  HVD_FLOAT16 = 6,
  HVD_FLOAT32 = 7,
  HVD_FLOAT64 = 8,
  HVD_BOOL = 9,
  HVD_BFLOAT16 = 10,
};

inline int DataTypeSize(DataType t) {
  switch (t) {
    case DataType::HVD_UINT8:
    case DataType::HVD_INT8:
    case DataType::HVD_BOOL:
      return 1;
    case DataType::HVD_UINT16:
    case DataType::HVD_INT16:
    case DataType::HVD_FLOAT16:
    case DataType::HVD_BFLOAT16:
      return 2;
    case DataType::HVD_INT32:
    case DataType::HVD_FLOAT32:
      return 4;
    case DataType::HVD_INT64:
    case DataType::HVD_FLOAT64:
      return 8;
  }
  return 0;
}

const char* DataTypeName(DataType t);

// ---- shapes ---------------------------------------------------------------

class TensorShape {
 public:
  TensorShape() = default;
  explicit TensorShape(std::vector<int64_t> dims) : dims_(std::move(dims)) {}
  void AddDim(int64_t d) { dims_.push_back(d); }
  int ndim() const { return static_cast<int>(dims_.size()); }
  int64_t dim(int i) const { return dims_[i]; }
  const std::vector<int64_t>& dims() const { return dims_; }
  int64_t num_elements() const {
    int64_t n = 1;
    for (auto d : dims_) n *= d;
    return n;
  }
  bool operator==(const TensorShape& o) const { return dims_ == o.dims_; }
  bool operator!=(const TensorShape& o) const { return dims_ != o.dims_; }
  std::string DebugString() const;

 private:
  std::vector<int64_t> dims_;
};

// ---- ops ------------------------------------------------------------------

enum class CollectiveOp : int {
  ALLREDUCE = 0,
  ALLGATHER = 1,
  BROADCAST = 2,
  JOIN = 3,
  REDUCESCATTER = 4,
  ALLTOALL = 5,
  BARRIER = 6,
  ERROR_OP = 7,
};

enum class ReduceOp : int {
  AVERAGE = 0,
  SUM = 1,
  ADASUM = 2,
  MIN = 3,
  MAX = 4,
};

// Device plane: where the tensor lives and which engine executes it.
enum class DevicePlane : int {
  XLA = 0,   // accelerator buffer; execution via registered callback
  HOST = 1,  // host memory; native in-process / socket ring execution
};

// ---- wire messages --------------------------------------------------------

// Rank -> coordinator (reference: message.h Request).
struct Request {
  int32_t rank = 0;
  CollectiveOp op = CollectiveOp::ALLREDUCE;
  ReduceOp reduce_op = ReduceOp::SUM;
  DataType dtype = DataType::HVD_FLOAT32;
  DevicePlane plane = DevicePlane::XLA;
  int32_t root_rank = -1;
  std::string name;
  TensorShape shape;
  double prescale = 1.0;
  double postscale = 1.0;
  // Allgather only: first dims of the individual chips this process
  // drives (XLA plane, local_size > 1). Empty = one chip of shape.dim(0).
  // Lets per-chip ragged gathers negotiate; the response publishes the
  // rank-major concatenation (one entry per CHIP) in first_dims.
  std::vector<int64_t> chip_dims;
  // Coordinator-side only (never serialized): steady-clock ns when this
  // request was ingested. Feeds the per-step rank-skew histogram and the
  // straggler detector (metrics.h) — 0 until the coordinator stamps it.
  int64_t arrive_ns = 0;
};

// Coordinator -> ranks (reference: message.h Response). One response may
// carry several fused tensors.
struct Response {
  CollectiveOp op = CollectiveOp::ALLREDUCE;
  ReduceOp reduce_op = ReduceOp::SUM;
  DataType dtype = DataType::HVD_FLOAT32;
  DevicePlane plane = DevicePlane::XLA;
  int32_t root_rank = -1;
  std::vector<std::string> tensor_names;
  std::vector<TensorShape> shapes;
  double prescale = 1.0;
  double postscale = 1.0;
  std::string error_reason;  // non-empty => ERROR_OP delivery
  // ALLGATHER only: per-tensor, per-rank first-dimension sizes (the
  // reference Response's tensor_sizes, message.h:companion of
  // SetDisplacements) — lets ranks gather ragged tensors with displacement
  // math and size their outputs without a separate size exchange.
  std::vector<std::vector<int64_t>> first_dims;
  int64_t total_bytes() const {
    int64_t n = 0;
    for (const auto& s : shapes) n += s.num_elements();
    return n * DataTypeSize(dtype);
  }
};

// ---- table entry ----------------------------------------------------------

using StatusCallback = std::function<void(const Status&)>;

// A pending collective submitted by the local process (reference:
// TensorTableEntry, common.h:232-251). `data`/`output` are host pointers on
// the HOST plane and null on the XLA plane.
struct TensorTableEntry {
  std::string name;
  Request request;
  void* data = nullptr;
  void* output = nullptr;
  int64_t handle = -1;
  StatusCallback callback;
  // Metrics plane (metrics.h): steady-clock ns at enqueue, and at the
  // moment the negotiated response reached PerformOperation. Together
  // they split a collective's latency into negotiation wait vs
  // execution (enqueue→negotiated→executed per op class).
  int64_t enqueue_ns = 0;
  int64_t negotiated_ns = 0;
};

}  // namespace hvd

#endif  // HVD_COMMON_H_
