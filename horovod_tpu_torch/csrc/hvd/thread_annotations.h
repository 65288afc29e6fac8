// Compile-time concurrency contracts for the native core.
//
// Clang's thread-safety analysis (-Wthread-safety, the capability system
// from the SEI/LLVM static-analysis literature) turns the locking
// discipline of this codebase into a CHECKED invariant: every field that
// must be read under a lock is declared GUARDED_BY(its mutex), every
// function with a locking precondition carries REQUIRES/EXCLUDES, and
// `make -C csrc tsa` (clang++ -fsyntax-only -Wthread-safety -Werror)
// fails the build on any access that violates the contract. This moves
// the repo's most persistent native bug class — extern-C getters racing
// hvd_shutdown's teardown, counters read lock-free, fields elastic
// re-init rewrites outside init_mu (re-fixed in PRs 5, 6, 7, 8, 9) —
// from "TSan maybe catches it at runtime" (unsound on this toolchain:
// the GCC-10 libtsan misses the pthread_cond_clockwait interceptor, see
// tensor_queue.cc) to a red compile line.
//
// Off Clang every macro expands to nothing, so GCC/production builds
// are bit-identical to the unannotated sources.
//
// Conventions (docs/static-analysis.md has the full rules):
//   - hvd::Mutex        annotated std::mutex (a CAPABILITY). The raw
//                       std::mutex is never used directly in csrc/hvd:
//                       the analysis cannot see through it.
//   - hvd::MutexLock    RAII guard (std::lock_guard role).
//   - hvd::UniqueLock   relockable RAII guard (std::unique_lock role)
//                       for condition waits; pairs with hvd::CondVar.
//   - hvd::CondVar      std::condition_variable_any — works with any
//                       BasicLockable, so waits keep the annotated lock
//                       type and the analysis tracks the capability
//                       across the wait. Predicate lambdas are NOT used
//                       with waits (a lambda body is analyzed as its
//                       own function and would need its own REQUIRES);
//                       wait loops are written out:
//                           while (!ready_) cv_.wait(lk);
//   - GUARDED_BY(mu)    on a field: every access must hold mu. Choose
//                       it over std::atomic when the field is part of a
//                       multi-field invariant or its lifetime is what
//                       the lock protects (the unique_ptrs init_mu
//                       guards); choose std::atomic for independent
//                       scalars polled lock-free (counters, topology
//                       ints, dispatch flags).
//   - REQUIRES(mu)      on a *Locked() helper: callers must hold mu.
//   - EXCLUDES(mu)      on a public method that acquires mu itself
//                       (the snapshot/drain paths): calling it with mu
//                       already held is a self-deadlock, caught at
//                       compile time.

#ifndef HVD_THREAD_ANNOTATIONS_H_
#define HVD_THREAD_ANNOTATIONS_H_

#include <condition_variable>
#include <mutex>

#if defined(__clang__)
#define HVD_TSA_ATTR(x) __attribute__((x))
#else
#define HVD_TSA_ATTR(x)  // no-op: GCC/MSVC have no capability analysis
#endif

#define CAPABILITY(x) HVD_TSA_ATTR(capability(x))
#define SCOPED_CAPABILITY HVD_TSA_ATTR(scoped_lockable)
#define GUARDED_BY(x) HVD_TSA_ATTR(guarded_by(x))
#define PT_GUARDED_BY(x) HVD_TSA_ATTR(pt_guarded_by(x))
#define ACQUIRED_BEFORE(...) HVD_TSA_ATTR(acquired_before(__VA_ARGS__))
#define ACQUIRED_AFTER(...) HVD_TSA_ATTR(acquired_after(__VA_ARGS__))
#define REQUIRES(...) HVD_TSA_ATTR(requires_capability(__VA_ARGS__))
#define REQUIRES_SHARED(...) \
  HVD_TSA_ATTR(requires_shared_capability(__VA_ARGS__))
#define ACQUIRE(...) HVD_TSA_ATTR(acquire_capability(__VA_ARGS__))
#define ACQUIRE_SHARED(...) \
  HVD_TSA_ATTR(acquire_shared_capability(__VA_ARGS__))
#define RELEASE(...) HVD_TSA_ATTR(release_capability(__VA_ARGS__))
#define RELEASE_SHARED(...) \
  HVD_TSA_ATTR(release_shared_capability(__VA_ARGS__))
#define TRY_ACQUIRE(...) HVD_TSA_ATTR(try_acquire_capability(__VA_ARGS__))
#define EXCLUDES(...) HVD_TSA_ATTR(locks_excluded(__VA_ARGS__))
#define ASSERT_CAPABILITY(x) HVD_TSA_ATTR(assert_capability(x))
#define RETURN_CAPABILITY(x) HVD_TSA_ATTR(lock_returned(x))
#define NO_THREAD_SAFETY_ANALYSIS HVD_TSA_ATTR(no_thread_safety_analysis)

namespace hvd {

// std::mutex with the CAPABILITY attribute: the unit of the analysis.
// Same footprint and cost as std::mutex (one member, inlined calls).
class CAPABILITY("mutex") Mutex {
 public:
  Mutex() = default;
  Mutex(const Mutex&) = delete;
  Mutex& operator=(const Mutex&) = delete;

  void lock() ACQUIRE() { mu_.lock(); }
  void unlock() RELEASE() { mu_.unlock(); }
  bool try_lock() TRY_ACQUIRE(true) { return mu_.try_lock(); }

 private:
  std::mutex mu_;
};

// RAII guard (std::lock_guard role) the analysis understands: the scope
// of a MutexLock IS the extent of the capability.
class SCOPED_CAPABILITY MutexLock {
 public:
  explicit MutexLock(Mutex& mu) ACQUIRE(mu) : mu_(mu) { mu_.lock(); }
  ~MutexLock() RELEASE() { mu_.unlock(); }
  MutexLock(const MutexLock&) = delete;
  MutexLock& operator=(const MutexLock&) = delete;

 private:
  Mutex& mu_;
};

// Relockable guard (std::unique_lock role) for condition waits and the
// unlock-work-relock pattern (Ring::SenderLoop, the heartbeat thread).
// BasicLockable, so hvd::CondVar (condition_variable_any) waits on it
// directly and the capability stays tracked across the wait.
class SCOPED_CAPABILITY UniqueLock {
 public:
  explicit UniqueLock(Mutex& mu) ACQUIRE(mu) : mu_(mu), held_(true) {
    mu_.lock();
  }
  ~UniqueLock() RELEASE() {
    if (held_) mu_.unlock();
  }
  UniqueLock(const UniqueLock&) = delete;
  UniqueLock& operator=(const UniqueLock&) = delete;

  void lock() ACQUIRE() {
    mu_.lock();
    held_ = true;
  }
  void unlock() RELEASE() {
    held_ = false;
    mu_.unlock();
  }

 private:
  Mutex& mu_;
  bool held_;
};

// condition_variable_any: waits on any BasicLockable, which keeps the
// annotated UniqueLock (and therefore the capability tracking) in the
// wait loop. The TSan steady-clock caveat applies unchanged — cv_any
// waits through the same libstdc++ primitive (see tensor_queue.cc).
using CondVar = std::condition_variable_any;

}  // namespace hvd

#endif  // HVD_THREAD_ANNOTATIONS_H_
